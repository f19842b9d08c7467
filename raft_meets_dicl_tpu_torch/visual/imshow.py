"""Interactive cv2 image windows with close-safe waiting.

Own copy of ``raft_meets_dicl_tpu/visual/imshow.py`` (reference
src/visual/imshow.py:7-39).
"""

import cv2

from . import flow_dark, flow_mb


class ImageWindow:
    def __init__(self, title):
        self.title = title

    def wait(self):
        # waitKey(0) deadlocks (and eats Ctrl-C) once the window is closed
        # via its 'x' button; poll visibility instead so both closing and
        # interrupting behave
        while cv2.getWindowProperty(self.title, cv2.WND_PROP_VISIBLE) >= 1:
            if cv2.waitKey(250) != -1:
                break


def show_image(title, rgb):
    cv2.imshow(title, rgb[:, :, ::-1])  # cv2 wants BGR
    return ImageWindow(title)


def show_flow(title, flow, *args, **kwargs):
    return show_image(title, flow_mb.flow_to_rgba(flow, *args, **kwargs))


def show_flow_dark(title, flow, *args, **kwargs):
    return show_image(title, flow_dark.flow_to_rgba(flow, *args, **kwargs))
