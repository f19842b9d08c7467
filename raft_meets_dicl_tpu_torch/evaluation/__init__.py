"""Inference step (counterpart of the JAX ``evaluation.make_eval_fn``,
plain single-device branch).

``make_eval_fn(model)`` returns ``step(img1, img2) -> (raw_output,
final_flow)`` that runs under ``torch.inference_mode()`` on the device the
model lives on; validation (``inspect.summary.make_val_step``) and serving
run it. The evaluation loop (``main evaluate``) and the ladder/warm-start
programs come with later slices (ROADMAP queue A).
"""

import torch


def make_eval_fn(model, model_args=None):
    """``step(img1, img2) -> (raw_output, final_flow)`` for NHWC image
    batches already on the model's device; ``model_args`` merge over the
    model's config-default arguments."""
    model_args = dict(model_args or {})
    adapter = model.get_adapter()

    def step(img1, img2):
        with torch.inference_mode():
            out = model.apply(img1, img2, train=False, **model_args)
            result = adapter.wrap_result(out, tuple(img1.shape[1:3]))
            return out, result.final()

    return step
