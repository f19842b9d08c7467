from . import checkpoint as checkpoint_mod
from . import eval as eval_mod
from . import serve as serve_mod
from . import train as train_mod

checkpoint = checkpoint_mod.checkpoint
evaluate = eval_mod.evaluate
serve = serve_mod.serve
train = train_mod.train

__all__ = ["checkpoint", "evaluate", "serve", "train"]
