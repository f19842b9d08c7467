"""The training step (counterpart of ``raft_meets_dicl_tpu/parallel/train.py``,
single-device path).

One eager step: the forward under the model's compute policy (bf16 convs
under mixed precision, parameters float32), the loss in float32,
``backward()``, the clip and the optimizer update at the learning rate the
host's schedulers pass in (the JAX ``external_lr=True`` contract). The
step reads nothing back to the host: every entry of its ``aux`` is a
device tensor, and the trainer decides when to fetch one.

With a wire format (``models.wire.WireFormat``) the step takes the
batch as it crossed the host→device copy (compact images, f16 flow, a
bit-packed valid mask) and decodes it first, on the device, as the JAX
step does inside its jit. The inference step, with the same decode, is
``evaluation.make_eval_fn``.

In-step accumulation (``accumulate=k``, the JAX ``lax.scan`` over
microbatches): the step takes a ``k·B`` batch and runs k forwards and
``backward()`` calls of B, so the gradients sum in ``.grad`` and only one
microbatch's activations are alive at a time; the sum divided by k is
the mean gradient, and one update applies it. The loss is the mean of
the microbatch losses, the finals are concatenated (the full-batch
``aux``), and live batch-norm statistics chain from microbatch to
microbatch, as in the scan.

The skip guard (``nonfinite='skip'``, the JAX step's skip-step
discipline): the step copies the parameters, the batch-norm buffers and
the optimizer state before it changes them, and where the final flow or
the applied update holds a non-finite value it puts the copies back with
``torch.where`` on the device, bit for bit, and adds one to
``TrainState.nonfinite_count``. No value is read back to the host. Adam's
step count, which ``torch.optim`` keeps on the host by default, is part of
that state: the trainer builds the optimizer with ``capturable=True``
under the guard on CUDA, so the count lives on the device and the guard
restores it there; on the CPU the count is a CPU tensor anyway. So a
skipped step leaves the next step's bias correction where JAX's
``jnp.where`` leaves it.

Not ported yet, and refused by name: meshes (ROADMAP slice 2 item 10,
DDP) and on-device augmentation (slice 7 entry 5, the on-device data
engine; host augmentation is the ``augment`` source).
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
    (clip + optimizer, ``strategy.spec.GradientTransform``), the count of
    steps run and ``nonfinite_count``, the updates the skip guard refused,
    as a device tensor (the trainer reads it with its other step scalars)."""

    def __init__(self, model, tx):
        self.model = model
        self.tx = tx
        self.step = 0
        device = tx.params[0].device if tx.params else None
        self.nonfinite_count = torch.zeros((), dtype=torch.int32,
                                           device=device)


def _refuse(what, item):
    raise NotImplementedError(
        f"make_train_step: {what} is not ported yet (ROADMAP {item})")


def _all_finite(tensors):
    """A 0-d bool tensor: every element of ``tensors`` finite (the largest
    magnitude of each is finite; a NaN propagates through the max)."""
    if not tensors:
        return torch.ones((), dtype=torch.bool)
    peaks = torch._foreach_max(torch._foreach_abs(tensors))
    return torch.isfinite(torch.stack(peaks)).all()


def make_train_step(model, loss_fn, mesh=None, loss_args=None,
                    model_args=None, with_grads=False, wire=None,
                    nonfinite=None, accumulate=1, augment=None):
    """Build ``step(state, lr, img1, img2, flow, valid) -> (state, aux)``.

    Inputs are NHWC tensors on the model's device. ``aux`` holds ``loss``,
    ``final`` (the final flow, detached), ``finite`` (all of ``final``
    finite; under ``nonfinite='skip'``: this step's update applied),
    ``nonfinite_count``, ``grad_norm`` (global l2 norm of the raw
    gradients, before clipping) and ``update_norm`` (of the parameter
    change the update applied); with ``with_grads`` also ``grads``, the raw
    gradients by parameter name. ``model_args`` and ``loss_args`` are the
    stage's and merge over the config defaults. ``accumulate=k`` splits
    the batch into k microbatches (its size must divide by k).
    """
    if mesh is not None:
        _refuse("a device mesh", "slice 2 item 10, DDP")
    if augment is not None:
        _refuse("on-device augmentation",
                "slice 7 entry 5, the on-device data engine")
    if nonfinite not in (None, "raise", "skip"):
        raise ValueError(f"invalid non-finite guard '{nonfinite}'")
    guard = nonfinite == "skip"
    accumulate = max(1, int(accumulate))

    loss_args = dict(loss_args or {})
    model_args = dict(model_args or {})
    adapter = model.get_adapter()
    names = [name for name, _ in model.module.named_parameters()]

    def forward_backward(img1, img2, flow, valid):
        out = model.apply(img1, img2, train=True, **model_args)
        result = adapter.wrap_result(out, tuple(img1.shape[1:3]))
        loss = loss_fn(model, result.output(), flow, valid, **loss_args)
        loss.backward()
        return loss.detach(), result.final().detach()

    def step(state, lr, img1, img2, flow, valid):
        tx = state.tx
        tx.zero_grad()
        if wire is not None:
            img1, img2, flow, valid = wire.decode(img1, img2, flow, valid)

        if guard:
            with torch.no_grad():
                buffers = list(model.module.buffers())
                saved_buffers = [b.clone() for b in buffers]
                saved = tx.snapshot()

        if accumulate == 1:
            loss, final = forward_backward(img1, img2, flow, valid)
        else:
            n = img1.shape[0]
            if n % accumulate:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{accumulate} microbatches")
            micro = zip(*(x.split(n // accumulate)
                          for x in (img1, img2, flow, valid)))
            losses, finals = zip(*(forward_backward(*mb) for mb in micro))
            # the mean of the microbatch means (the JAX scan's lsum / k)
            loss = losses[0]
            for l in losses[1:]:
                loss = loss + l
            loss = loss / accumulate
            final = torch.cat(finals)

        with torch.no_grad():
            grads = tx.grads()
            if accumulate > 1:
                torch._foreach_div_(grads, float(accumulate))
            aux = {"grad_norm": global_norm(grads)}
            if with_grads:
                aux["grads"] = {n: g.clone() for n, g in zip(names, grads)}
            before = [p.detach().clone() for p in tx.params]

            applied = tx.update(lr)

            change = torch._foreach_sub([p.detach() for p in tx.params],
                                        before)
            aux["update_norm"] = global_norm(change)
            finite = torch.isfinite(final).all()
            count = state.nonfinite_count
            if guard:
                # the update the optimizer proposed: with MultiSteps on
                # every call, as JAX's zero update times a poisoned mean
                # or rate is NaN between updates too
                ok = finite & _all_finite(
                    tx.proposed if torch.is_tensor(applied) else change)
                tx.restore(ok, saved)
                for b, old in zip(buffers, saved_buffers):
                    torch.where(ok, b, old, out=b)
                finite = ok
                count = count + (~ok).to(torch.int32)
                state.nonfinite_count = count
            aux.update(loss=loss, final=final, finite=finite,
                       nonfinite_count=count, target=flow, valid=valid)

        state.step += 1
        return state, aux

    return step
