"""raft_meets_dicl_tpu_torch — the PyTorch/CUDA port of raft_meets_dicl_tpu.

A second package beside the JAX one, with the same module layout and
names so each module's counterpart is easy to find. It imports ``torch``
and never JAX, Flax, Optax or the JAX package; the JAX package stays the
reference that the tests hold the port against.

Ported so far: ``raft/baseline``, the ``raft+dicl`` coarse-to-fine models
and ``raft/fs``, serving and training.

- ``utils/``      — config load/store, expressions, seeds, env knobs.
- ``models/``     — model framework (registry, adapters, input spec), the
                    encoders/blocks/norms and ``models/impls/`` as
                    ``nn.Module``s; public functions keep the JAX NHWC
                    layout (flows (B, H, W, 2), channel 0 = x).
- ``ops/``        — correlation volumes and lookups, pooling, upsampling in
                    plain torch, and the hand-written CUDA kernels for
                    Hopper (``csrc/``: ``convex_combine_8x``,
                    ``sample_window``, ``windowed_corr``), built with
                    ``nvcc`` at first use.
- ``data/``, ``strategy/``, ``parallel/`` — the training path.
- ``evaluation/`` — the inference step.
- ``serve/``      — batcher, session, scheduler, open-loop load generator.
- ``cmd/``, ``main.py`` — ``python -m raft_meets_dicl_tpu_torch.main
                    serve|train``.
- ``convert.py``  — JAX variables (numpy tree) → this package's state_dict.
"""

__version__ = "0.1.0"
