"""raft_meets_dicl_tpu_torch — the PyTorch/CUDA port of raft_meets_dicl_tpu.

A second package beside the JAX one, with the same module layout and
names so each module's counterpart is easy to find. It imports ``torch``
and never JAX, Flax, Optax or the JAX package; the JAX package stays the
reference that the tests hold the port against.

Ported so far: ``raft/baseline``, the ``raft+dicl`` coarse-to-fine models
and ``raft/fs``, serving and training, with the training lifecycle:
validation, metrics, TensorBoard summaries, checkpoints, resume and
serving from a checkpoint (the port's own files or the JAX package's).

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
- ``data/``, ``strategy/``, ``parallel/`` — the training path;
                    ``strategy/checkpoint.py`` the checkpoint files and
                    their retention.
- ``metrics/``, ``inspect/``, ``visual/`` — metrics on the device,
                    validation, TensorBoard event files, flow images.
- ``evaluation/`` — the inference step.
- ``serve/``      — batcher, session, scheduler, open-loop load generator.
- ``cmd/``, ``main.py`` — ``python -m raft_meets_dicl_tpu_torch.main
                    serve|train|checkpoint``.
- ``convert.py``  — JAX variables (numpy tree) → this package's state_dict,
                    and the JAX package's checkpoints (weights, AdamW
                    state) into a module and an optimizer.
"""

__version__ = "0.1.0"
