"""Hidden-state upsamplers between coarse-to-fine pyramid levels
(counterpart of the JAX ``common/hsup.py``).

They carry the GRU hidden state from a coarse level into the next finer
level's initialization. ``none`` uses the fine init; ``bilinear`` adds an
identity-initialized 1x1 conv of the coarse state, resized 2x; ``crossattn``
attends from the fine init (queries) to the coarse state's zero-padded
3x3 neighbourhood (keys, values).

NCHW, like the port's recurrent state: ``forward(h_prev, h_init)`` with
h_prev (B, C, h/2, w/2) and h_init (B, C, h, w). The convs compute in the
promoted type of input and weight (float32), as the JAX modules do.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .util import Conv2d


def upsample2d_bilinear(x, size):
    """align_corners=True bilinear resize of an NCHW map to ``size`` =
    (H, W), computed in float32, returned in x's dtype."""
    y = F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                      align_corners=True)
    return y.to(x.dtype)


class HUpNone(nn.Module):
    def forward(self, h_prev, h_init):
        return h_init


class HUpBilinear(nn.Module):
    """Identity-init 1x1 conv on the coarse state, 2x bilinear, add."""

    def __init__(self, recurrent_channels):
        super().__init__()
        self.conv1 = Conv2d(recurrent_channels, recurrent_channels, 1,
                            init="identity")

    def forward(self, h_prev, h_init):
        h_prev = upsample2d_bilinear(self.conv1(h_prev), h_init.shape[2:])
        return h_init + h_prev


class HUpCrossAttn(nn.Module):
    """Local 3x3-window cross-attention from the fine init to the coarse
    state."""

    def __init__(self, recurrent_channels, key_channels=64):
        super().__init__()
        cv, ck = recurrent_channels, key_channels
        self.conv_q = Conv2d(cv, ck, 1)
        self.conv_k = Conv2d(cv, ck, 1)
        self.conv_v_prev = Conv2d(cv, cv, 1)
        self.conv_v_init = Conv2d(cv, cv, 1)
        self.conv_out = Conv2d(cv, cv, 1)

    @staticmethod
    def _windows(t, size):
        """(B, C, h2, w2) -> (B, 9, C, h, w): the zero-padded 3x3
        neighbourhoods, (dy, dx) row-major, each coarse cell repeated over
        its block of the fine grid."""
        b, c, h2, w2 = t.shape
        t = F.unfold(t, 3, padding=1).reshape(b, c, 9, h2, w2).transpose(1, 2)
        ry, rx = size[0] // h2, size[1] // w2
        return t.repeat_interleave(ry, dim=3).repeat_interleave(rx, dim=4)

    def forward(self, h_prev, h_init):
        size = h_init.shape[2:]
        q = self.conv_q(h_init)                              # (B, ck, h, w)
        k_win = self._windows(self.conv_k(h_prev), size)     # (B, 9, ck, h, w)
        v_win = self._windows(self.conv_v_prev(h_prev), size)

        attn = torch.softmax(torch.einsum("bchw,bkchw->bkhw", q, k_win), dim=1)
        x = torch.einsum("bkhw,bkchw->bchw", attn, v_win)
        return self.conv_out(self.conv_v_init(h_init) + x)


def make_hidden_state_upsampler(type, recurrent_channels):
    if type == "none":
        return HUpNone()
    if type == "bilinear":
        return HUpBilinear(recurrent_channels)
    if type == "crossattn":
        return HUpCrossAttn(recurrent_channels)
    raise ValueError(f"unknown hidden state upsampler type '{type}'")
