"""Model spec loading: the string-typed model/loss registries.

Mirrors the reference registry surface (src/models/config.py:9-94): a model
config file carries name/id plus typed ``model``, ``loss``, and ``input``
sections. Model and loss implementations self-register via
``register_model``/``register_loss`` when their module is imported, so the
registry grows with the zoo without a central edit point.
"""

from .. import utils
from . import input as input_mod
from . import model as model_mod

_MODELS = {}
_LOSSES = {}

# model types of the JAX package not ported yet, by the ROADMAP item that
# brings each: loading one refuses naming it
_LATER = {
    **dict.fromkeys(("dicl/baseline", "dicl/64to8", "dicl/multiscale"),
                    "slice 4 item 6, dicl/baseline"),
    **dict.fromkeys(("raft+dicl/ml", "raft+dicl/sl"),
                    "slice 4 item 5, raft+dicl/ml and raft+dicl/sl"),
    **dict.fromkeys(("raft/sl", "raft/sl-ctf-l2", "raft/sl-ctf-l3",
                     "raft/sl-ctf-l4"),
                    "slice 5, impls/raft_sl.py and raft_sl_ctf.py"),
    **dict.fromkeys(("raft/cl", "raft+dicl/sl-ca", "wip/warp/1",
                     "wip/warp/2", "wip/warp/multiscale",
                     "wip/warp/multiscale+corr_hinge",
                     "wip/warp/multiscale+corr_mse"),
                    "slice 5, impls/outdated"),
}


def register_model(cls):
    """Class decorator: add a Model subclass to the type registry."""
    if cls.type is None:
        raise ValueError(f"model class {cls.__name__} has no type id")
    _MODELS[cls.type] = cls
    return cls


def register_loss(cls):
    """Class decorator: add a Loss subclass to the type registry."""
    if cls.type is None:
        raise ValueError(f"loss class {cls.__name__} has no type id")
    _LOSSES[cls.type] = cls
    return cls


def model_types():
    from . import impls  # noqa: F401 — triggers registration

    return sorted(_MODELS)


def loss_types():
    from . import impls  # noqa: F401 — triggers registration

    return sorted(_LOSSES)


class ModelSpec:
    """name/id + model + loss + input — one loadable model definition."""

    @classmethod
    def from_config(cls, cfg):
        return cls(
            cfg["name"],
            cfg["id"],
            load_model(cfg["model"]),
            load_loss(cfg["loss"]),
            load_input(cfg.get("input")),
        )

    def __init__(self, name, id, model, loss, input):
        self.name = name
        self.id = id
        self.model = model
        self.loss = loss
        self.input = input

    def get_config(self):
        return {
            "name": self.name,
            "id": self.id,
            "model": self.model.get_config(),
            "loss": self.loss.get_config(),
            "input": self.input.get_config(),
        }


def load_input(cfg) -> input_mod.InputSpec:
    return input_mod.InputSpec.from_config(cfg)


def load_loss(cfg) -> model_mod.Loss:
    from . import impls  # noqa: F401 — triggers registration

    ty = cfg["type"]
    if ty not in _LOSSES:
        raise ValueError(f"unknown loss type '{ty}'")
    return _LOSSES[ty].from_config(cfg)


def load_model(cfg) -> model_mod.Model:
    from . import impls  # noqa: F401 — triggers registration

    ty = cfg["type"]
    if ty in _LATER:
        raise NotImplementedError(f"model type '{ty}' is not ported yet "
                                  f"(ROADMAP {_LATER[ty]})")
    if ty not in _MODELS:
        raise ValueError(f"unknown model type '{ty}'")
    return _MODELS[ty].from_config(cfg)


def load(cfg) -> ModelSpec:
    if not isinstance(cfg, dict):
        cfg = utils.config.load(cfg)

    return ModelSpec.from_config(cfg)
