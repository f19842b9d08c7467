"""Inspector callback protocol: the trainer is observable, observability
lives elsewhere (counterpart of ``raft_meets_dicl_tpu/strategy/inspector.py``).

The port's trainer adds ``flush``: it is called where the trainer reads its
pending step scalars back from the device (every ``FETCH_EVERY`` steps,
at each epoch's end), so an inspector can read its own device values at
the same point instead of synchronising every step.
"""


class Inspector:
    wants_gradients = False

    def setup(self, log, ctx):
        pass

    def on_step_start(self, log, ctx, stage, epoch, i):
        pass

    def on_step_end(self, log, ctx, stage, epoch, i):
        pass

    def on_batch_start(self, log, ctx, stage, epoch, i, img1, img2, target,
                       valid, meta):
        pass

    def on_batch(self, log, ctx, stage, epoch, i, img1, img2, target, valid,
                 meta, result, loss):
        pass

    def on_epoch_start(self, log, ctx, stage, epoch):
        pass

    def on_epoch(self, log, ctx, stage, epoch):
        pass

    def on_stage_start(self, log, ctx, stage):
        pass

    def on_stage(self, log, ctx, stage):
        pass

    def flush(self):
        pass
