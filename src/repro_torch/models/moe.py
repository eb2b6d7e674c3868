"""Feed-forward layers.  Only the dense MLP is ported so far; the routed
mixture-of-experts layer waits for ROADMAP §1 item 8."""
from __future__ import annotations

import torch.nn.functional as F

from .common import dense


def dense_ffn(params: dict, x, activation: str):
    """Plain MLP; ``params`` has w_up/w_down and (for swiglu) w_gate."""
    if activation != "swiglu":
        raise NotImplementedError(
            f"activation {activation!r}: only swiglu is ported (ROADMAP §1 item 8)")
    h = F.silu(dense(x, params["w_gate"])) * dense(x, params["w_up"])
    return dense(h, params["w_down"])
