from . import serve as serve_mod
from . import train as train_mod

serve = serve_mod.serve
train = train_mod.train

__all__ = ["serve", "train"]
