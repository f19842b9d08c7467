"""Flow visualization: Middlebury/dark color coding, EPE and Fl maps, the
forwards-backwards products and the backwards-warp preview (counterpart
of ``raft_meets_dicl_tpu/visual``; host-side numpy, the warp through the
port's ``ops/warp.py`` on CPU tensors)."""

from . import (bad_pixel, colormaps, epe, flow_dark, flow_mb, imshow,
               occlusion, utils, warp)
from .flow_mb import color_wheel

end_point_error = epe.end_point_error
end_point_error_abs = epe.end_point_error_abs
fl_error = bad_pixel.fl_error
flow_to_rgba = flow_mb.flow_to_rgba
flow_to_rgba_dark = flow_dark.flow_to_rgba
warp_backwards = warp.warp_backwards
occlusion_overlay = occlusion.occlusion_overlay
confidence_to_rgba = occlusion.confidence_to_rgba

show_image = imshow.show_image
show_flow = imshow.show_flow
show_flow_dark = imshow.show_flow_dark

__all__ = [
    "bad_pixel", "colormaps", "epe", "flow_dark", "flow_mb", "imshow",
    "occlusion", "utils", "warp",
    "color_wheel", "end_point_error", "end_point_error_abs", "fl_error",
    "flow_to_rgba", "flow_to_rgba_dark", "warp_backwards",
    "occlusion_overlay", "confidence_to_rgba", "show_image", "show_flow",
    "show_flow_dark",
]
