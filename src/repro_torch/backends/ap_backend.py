"""``ap_sim`` backend: the functional 2D-AP simulator as an execution target
(port of ``src/repro/backends/ap_backend.py``).

Softmax rows go through the Fig.-5 dataflow program
(``ap.dataflow.ap_softmax_rows`` on ``ap.functional_sim.APSim``, numpy on
the host): ``quantize_stable_scores`` on the scores' device, the codes to
the host, the simulated hardware's probability codes back to the scores'
device, one multiply by 2^-P_out there (``dequantize_probs``). The program
is batched: every row of a call executes as one vectorized numpy pass over
a ``[R, L]`` field. The float boundary is every integer backend's, so the
codes equal the plain torch Alg. 1's (``int``) bit for bit.

The round trip reads the device back on the host, which a CUDA graph cannot
capture: the backend says so (``capturable = False``), and the engine then
runs its decode steps op by op and reports no replays. On the ``meta``
device (the cost meter's pass) nothing goes to the host.

Cost metering stays analytic (the shared Table-II meter): the dataflow
program charges exactly ``cost_model.softmax_cycle_breakdown`` per vector.
"""

from __future__ import annotations

import torch

from repro_torch.ap.dataflow import ap_softmax_rows
from repro_torch.backends.registry import register_backend
from repro_torch.backends.torch_backends import IntBackendBase
from repro_torch.core.quantization import dequantize_probs, quantize_stable_scores


@register_backend("ap_sim")
class APSimBackend(IntBackendBase):
    """Bit-exact functional AP execution (a host round trip; CPU speed)."""

    name = "ap_sim"
    differentiable = False  # numpy on the host: no backward
    capturable = False      # a host round trip: no CUDA-graph capture

    def apply(self, scores, mask=None, axis: int = -1):
        cfg = self.cfg
        x = scores
        if mask is not None:
            mask = torch.broadcast_to(mask, x.shape)
        x = x.movedim(axis, -1)
        if mask is not None:
            mask = mask.movedim(axis, -1)
        shape = x.shape
        v = quantize_stable_scores(x, cfg, mask=mask, axis=-1)
        if v.device.type == "meta":
            codes = v
        else:
            valid = None if mask is None else mask.reshape(-1, shape[-1]).cpu().numpy()
            out, _ = ap_softmax_rows(v.reshape(-1, shape[-1]).cpu().numpy(), cfg,
                                     mask=valid)
            codes = torch.from_numpy(out.astype("int32")).to(v.device).reshape(shape)
        return dequantize_probs(codes, cfg).movedim(-1, axis)
