"""The training step (counterpart of ``raft_meets_dicl_tpu/parallel/train.py``,
single-device path).

One eager step: the forward under the model's compute policy (bf16 convs
under mixed precision, parameters float32), the loss in float32,
``backward()``, the clip and the optimizer update at the learning rate the
host's schedulers pass in (the JAX ``external_lr=True`` contract). The
step reads nothing back to the host: every entry of its ``aux`` is a
device tensor, and the trainer decides when to fetch one.

Not ported yet, and refused by name: meshes (ROADMAP slice 2 item 10,
DDP), wire formats (item 9), in-step accumulation (item 8), the ``skip``
non-finite guard (item 7) and on-device augmentation (slice 7 entry 5,
the on-device data engine; host augmentation is the ``augment`` source).
"""

import torch


def global_norm(tensors):
    """optax ``global_norm``: the l2 norm of all tensors as one vector, as
    a 0-d tensor on their device."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


class TrainState:
    """What the train step carries: the model (whose module holds the
    parameters and the batch-norm statistics), the gradient transform
    (clip + optimizer, ``strategy.spec.GradientTransform``) and the count
    of applied steps."""

    def __init__(self, model, tx):
        self.model = model
        self.tx = tx
        self.step = 0


def _refuse(what, item):
    raise NotImplementedError(
        f"make_train_step: {what} is not ported yet (ROADMAP {item})")


def make_train_step(model, loss_fn, mesh=None, loss_args=None,
                    model_args=None, with_grads=False, wire=None,
                    nonfinite=None, accumulate=1, augment=None):
    """Build ``step(state, lr, img1, img2, flow, valid) -> (state, aux)``.

    Inputs are NHWC tensors on the model's device. ``aux`` holds ``loss``,
    ``final`` (the final flow, detached), ``finite`` (all of ``final``
    finite), ``grad_norm`` (global l2 norm of the raw gradients, before
    clipping) and ``update_norm`` (of the parameter change the update
    applied); with ``with_grads`` also ``grads``, the raw gradients by
    parameter name. ``model_args`` and ``loss_args`` are the stage's and
    merge over the config defaults.
    """
    if mesh is not None:
        _refuse("a device mesh", "slice 2 item 10, DDP")
    if wire is not None:
        _refuse("a wire format", "slice 2 item 9, wire formats")
    if augment is not None:
        _refuse("on-device augmentation",
                "slice 7 entry 5, the on-device data engine")
    if int(accumulate) > 1:
        _refuse("in-step gradient accumulation",
                "slice 2 item 8, in-step accumulation")
    if nonfinite not in (None, "raise"):
        _refuse(f"the non-finite policy '{nonfinite}'",
                "slice 2 item 7, non-finite skip/rollback policies")

    loss_args = dict(loss_args or {})
    model_args = dict(model_args or {})
    adapter = model.get_adapter()
    names = [name for name, _ in model.module.named_parameters()]

    def step(state, lr, img1, img2, flow, valid):
        tx = state.tx
        tx.zero_grad()

        out = model.apply(img1, img2, train=True, **model_args)
        result = adapter.wrap_result(out, tuple(img1.shape[1:3]))
        loss = loss_fn(model, result.output(), flow, valid, **loss_args)
        loss.backward()

        with torch.no_grad():
            grads = tx.grads()
            aux = {"grad_norm": global_norm(grads)}
            if with_grads:
                aux["grads"] = {n: g.clone() for n, g in zip(names, grads)}
            before = [p.detach().clone() for p in tx.params]

            tx.update(lr)

            aux["update_norm"] = global_norm(
                torch._foreach_sub([p.detach() for p in tx.params], before))
            final = result.final().detach()
            aux.update(loss=loss.detach(), final=final,
                       finite=torch.isfinite(final).all())

        state.step += 1
        return state, aux

    return step
