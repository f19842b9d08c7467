"""raft_meets_dicl_tpu_torch — the PyTorch/CUDA port of raft_meets_dicl_tpu.

A second package beside the JAX one, with the same module layout and
names so each module's counterpart is easy to find. It imports ``torch``
and never JAX, Flax, Optax or the JAX package; the JAX package stays the
reference that the tests hold the port against.

Ported so far (the ``raft/baseline`` serving path):

- ``utils/``      — config load/store.
- ``models/``     — model framework (registry, adapters, input spec), the
                    RAFT encoders/blocks/norms and ``models/impls/raft.py``
                    as ``nn.Module``s; public functions keep the JAX NHWC
                    layout (flows (B, H, W, 2), channel 0 = x).
- ``ops/``        — correlation pyramid + windowed lookup and convex 8x
                    upsampling in plain torch, and ``convex_combine_8x``,
                    a hand-written CUDA kernel for Hopper (``csrc/``),
                    built with ``nvcc`` at first use.
- ``evaluation/`` — the inference step.
- ``serve/``      — batcher, session, scheduler, open-loop load generator.
- ``cmd/``, ``main.py`` — ``python -m raft_meets_dicl_tpu_torch.main serve``.
- ``convert.py``  — JAX variables (numpy tree) → this package's state_dict.
"""

__version__ = "0.1.0"
