"""Dataset: file-pattern layouts, parameters, splits, filters, and loaders.

Covers the reference's dataset machinery (src/data/dataset.py): a dataset
spec describes on-disk file layouts via format patterns
(``'{type}/{pass}/{scene}/frame_{idx:04d}.png'``), exposes user-selectable
parameters (e.g. ``pass: clean|final`` on Sintel) that substitute into the
patterns, supports split files (one token per sample) and sample filters,
and loads images/flow through pluggable per-format loaders.

Config types round-trip: ``dataset`` collections, ``generic`` /
``generic-backwards`` / ``multi`` layouts, ``combine`` / ``exclude`` /
``file`` filters, ``generic-image`` / ``generic-flow`` loaders.
Counterpart of the JAX package's ``data/dataset.py``.
"""

from pathlib import Path

import numpy as np

from ..utils import config
from . import io
from .collection import Collection, Metadata, SampleArgs, SampleId
from .patterns import FormatPattern, to_glob


class Dataset(Collection):
    type = "dataset"

    @classmethod
    def from_config(cls, path, cfg):
        cls._typecheck(cfg)

        path = Path(path)
        spec = cfg["spec"]
        params = cfg.get("parameters", {})
        filter_ = build_filter(path, cfg.get("filter"))

        # spec may be inline or a reference to another config file; referenced
        # paths resolve relative to the referencing file
        if not isinstance(spec, dict):
            specfile = spec
            spec = config.load(path / specfile)
            path = (path / specfile).parent

        return cls._from_spec(path, spec, params, filter_)

    @classmethod
    def _from_spec(cls, path, spec, params, filter_):
        loaders = spec.get("loader", {})
        split = spec.get("split")

        return cls(
            id=spec["id"],
            name=spec["name"],
            path=Path(path) / Path(spec.get("path", ".")),
            layout=build_layout(spec["layout"]),
            split=Split.from_config(path, split) if split is not None else None,
            filter=filter_,
            param_desc=ParameterDesc.from_config(spec.get("parameters", {})),
            param_vals=params,
            image_loader=build_loader(loaders.get("image", "generic-image")),
            flow_loader=build_loader(loaders.get("flow", "generic-flow")),
        )

    def __init__(self, id, name, path, layout, split, filter, param_desc,
                 param_vals, image_loader, flow_loader):
        super().__init__()

        if not path.exists():
            raise ValueError(f"dataset root path does not exist: {path}")

        self.id = id
        self.name = name
        self.path = path
        self.layout = layout
        self.split = split
        self.filter = filter
        self.param_desc = param_desc
        self.param_vals = param_vals
        self.image_loader = image_loader
        self.flow_loader = flow_loader

        self.files = layout.build_file_list(path, param_desc, param_vals)
        if self.split is not None:
            self.files = self.split.filter(self.files, param_vals)
        if self.filter is not None:
            self.files = self.filter.filter(self.files)

    def get_config(self):
        return {
            "type": self.type,
            "spec": {
                "id": self.id,
                "name": self.name,
                "path": str(self.path),
                "layout": self.layout.get_config(),
                "split": self.split.get_config() if self.split is not None else None,
                "parameters": self.param_desc.get_config(),
                "loader": {
                    "image": self.image_loader.get_config(),
                    "flow": self.flow_loader.get_config(),
                },
            },
            "parameters": self.param_vals,
            "filter": self.filter.get_config() if self.filter is not None else None,
        }

    def __str__(self):
        return f"Dataset {{ name: '{self.name}', path: '{self.path}' }}"

    def description(self):
        return self.name

    def __getitem__(self, index):
        img1_path, img2_path, flow_path, key = self.files[index]

        img1 = self.image_loader.load(img1_path)
        img2 = self.image_loader.load(img2_path)
        assert img1.shape[:2] == img2.shape[:2]

        # test datasets may not provide ground-truth flow
        if flow_path is not None and flow_path.exists():
            flow, valid = self.flow_loader.load(flow_path)
            assert img1.shape[:2] == flow.shape[:2] == valid.shape[:2]
            flow, valid = flow[None], valid[None]
        else:
            flow, valid = None, None

        meta = Metadata(
            valid=True,
            dataset_id=self.id,
            sample_id=key,
            original_extents=((0, img1.shape[0]), (0, img1.shape[1])),
        )

        return img1[None], img2[None], flow, valid, [meta]

    def __len__(self):
        return len(self.files)


# -- layouts ----------------------------------------------------------------


class Layout:
    type = None

    @classmethod
    def _typecheck(cls, cfg):
        if cfg["type"] != cls.type:
            raise ValueError(f"invalid layout type '{cfg['type']}', expected '{cls.type}'")

    def get_config(self):
        raise NotImplementedError

    def build_file_list(self, path, param_desc, param_vals):
        raise NotImplementedError


def _discover(path, pat_img):
    """Glob candidates and invert the image pattern over them.

    Returns (groups, fields): ``groups`` is a list of
    ``(positional_args, named_without_idx, idx)`` and ``fields`` the named
    field order (minus ``idx``).
    """
    compiled = FormatPattern(str(path / pat_img))
    fields = [f for f in compiled.named_fields if f != "idx"]

    groups = []
    for candidate in path.glob(to_glob(pat_img)):
        parsed = compiled.match(candidate)
        if parsed is None:
            continue
        positional = tuple(parsed[i] for i in compiled.positional_fields)
        named = tuple(parsed[f] for f in fields)
        groups.append((positional, named, parsed["idx"]))

    return groups, fields


def _drop_sequence_tails(groups, step):
    """Remove the final frame of every consecutive-index run.

    Image sequences are paired frame-to-next (or frame-to-previous for
    ``step=-1``); the run's last frame has no partner, so it is dropped.
    ``groups`` must be sorted so that partners are adjacent.
    """
    kept = []
    prev = None
    for pos, named, idx in groups:
        if prev is not None and prev != (pos, named, idx - step):
            del kept[-1]
        kept.append((pos, named, idx))
        prev = (pos, named, idx)

    if kept:
        del kept[-1]
    return kept


class _SequenceLayout(Layout):
    """Shared implementation of the forward/backward sequence layouts."""

    step = None  # +1: pair (idx, idx+1); -1: pair (idx, idx-1)

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg["images"], cfg["flows"], cfg["key"])

    def __init__(self, pat_img, pat_flow, pat_key):
        super().__init__()
        self.pat_img = pat_img
        self.pat_flow = pat_flow
        self.pat_key = pat_key

    def get_config(self):
        return {
            "type": self.type,
            "images": self.pat_img,
            "flows": self.pat_flow,
            "key": self.pat_key,
        }

    def build_file_list(self, path, param_desc, param_vals):
        groups, fields = _discover(path, self.pat_img)
        groups.sort(key=lambda g: (g[0], g[1], self.step * g[2]))
        groups = _drop_sequence_tails(groups, self.step)

        subs = param_desc.get_substitutions(param_vals)

        files = []
        for positional, named_vals, idx in groups:
            named = dict(zip(fields, named_vals))

            # parameter selections must agree with what was parsed from disk
            if any(k in named and named[k] != v for k, v in subs.items()):
                continue
            named.update(subs)

            img1 = self.pat_img.format(*positional, idx=idx, **named)
            img2 = self.pat_img.format(*positional, idx=idx + self.step, **named)
            flow = self.pat_flow.format(*positional, idx=idx, **named)

            key = SampleId(
                format=self.pat_key,
                img1=SampleArgs(list(positional), named | {"idx": idx}),
                img2=SampleArgs(list(positional), named | {"idx": idx + self.step}),
            )
            files.append((path / img1, path / img2, path / flow, key))

        return sorted(files, key=lambda f: str(f[3]))


class GenericLayout(_SequenceLayout):
    type = "generic"
    step = 1


class GenericBackwardsLayout(_SequenceLayout):
    type = "generic-backwards"
    step = -1


class MultiLayout(Layout):
    """Selects one of several layouts via a dataset parameter."""

    type = "multi"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        instances = {k: build_layout(v) for k, v in cfg["instances"].items()}
        return cls(cfg["parameter"], instances)

    def __init__(self, param, layouts):
        super().__init__()
        self.param = param
        self.layouts = layouts

    def get_config(self):
        return {
            "type": self.type,
            "parameter": self.param,
            "instances": {k: v.get_config() for k, v in self.layouts.items()},
        }

    def build_file_list(self, path, param_desc, param_vals):
        layout = self.layouts[param_vals[self.param]]
        return layout.build_file_list(path, param_desc, param_vals)


# -- parameters and splits --------------------------------------------------


class Parameter:
    """A user-selectable dataset parameter with pattern substitutions.

    ``sub`` is either a field name (value substitutes directly) or a mapping
    from value to a dict of field substitutions.
    """

    @classmethod
    def from_config(cls, name, cfg):
        return cls(name, cfg.get("values"), cfg.get("sub"))

    def __init__(self, name, values, sub):
        self.name = name
        self.values = values
        self.sub = sub

    def get_config(self):
        return {"values": self.values, "sub": self.sub}

    def get_substitutions(self, value):
        if self.values is not None and value not in self.values:
            raise KeyError(f"value '{value}' is not valid for parameter '{self.name}'")

        if isinstance(self.sub, str):
            return {self.sub: value}
        return dict(self.sub[value])


class ParameterDesc:
    @classmethod
    def from_config(cls, cfg):
        return cls({name: Parameter.from_config(name, c) for name, c in cfg.items()})

    def __init__(self, parameters):
        self.parameters = parameters

    def get_config(self):
        return {p.name: p.get_config() for p in self.parameters.values()}

    def get_substitutions(self, values):
        subs = {}
        for k, v in values.items():
            if k in self.parameters:
                subs.update(self.parameters[k].get_substitutions(v))
        return subs


class Split:
    """Train/test split from a token file (one token per sample, in order)."""

    @classmethod
    def from_config(cls, path, cfg):
        return cls(Path(path) / cfg["file"], dict(cfg["values"]), cfg["parameter"])

    def __init__(self, file, values, parameter):
        self.file = file
        self.values = values
        self.parameter = parameter

    def get_config(self):
        return {
            "file": str(self.file),
            "values": self.values,
            "parameter": self.parameter,
        }

    def filter(self, files, params):
        selection = params.get(self.parameter)
        if selection is None:  # no selection made: use everything
            return files

        wanted = self.values[selection]
        tokens = Path(self.file).read_text().split()
        return [f for f, tok in zip(files, tokens) if tok == wanted]


# -- filters ----------------------------------------------------------------


class Filter:
    type = None

    @classmethod
    def _typecheck(cls, cfg):
        ty = cfg["type"] if isinstance(cfg, dict) else cfg
        if ty != cls.type:
            raise ValueError(f"invalid filter type '{ty}', expected '{cls.type}'")

    def get_config(self):
        raise NotImplementedError

    def filter(self, files):
        raise NotImplementedError


class CombineFilter(Filter):
    type = "combine"

    @classmethod
    def from_config(cls, path, cfg):
        cls._typecheck(cfg)
        return cls([build_filter(path, f) for f in cfg["filters"]])

    def __init__(self, filters):
        super().__init__()
        self.filters = filters

    def get_config(self):
        return {"type": self.type, "filters": [f.get_config() for f in self.filters]}

    def filter(self, files):
        for f in self.filters:
            files = f.filter(files)
        return files


class ExcludeFilter(Filter):
    """Excludes samples whose id arguments match any of the given rules."""

    type = "exclude"

    @classmethod
    def from_config(cls, path, cfg):
        cls._typecheck(cfg)
        return cls(cfg["exclude"])

    def __init__(self, exclude):
        super().__init__()
        self.exclude = exclude

    def get_config(self):
        return {"type": self.type, "exclude": self.exclude}

    def filter(self, files):
        def excluded(file):
            args = file[3].img1.kwargs
            return any(
                all(k in args and args[k] == v for k, v in rule.items())
                for rule in self.exclude
            )

        return [f for f in files if not excluded(f)]


class FileFilter(Filter):
    """Keeps samples whose split-file token equals ``value``."""

    type = "file"

    @classmethod
    def from_config(cls, path, cfg):
        cls._typecheck(cfg)
        return cls(Path(path) / cfg["file"], str(cfg["value"]))

    def __init__(self, file, value):
        super().__init__()
        self.file = file
        self.value = value

    def get_config(self):
        return {"type": self.type, "file": str(self.file), "value": self.value}

    def filter(self, files):
        tokens = Path(self.file).read_text().split()
        return [f for f, tok in zip(files, tokens) if tok == self.value]


# -- file loaders -----------------------------------------------------------


class FileLoader:
    type = None

    @classmethod
    def _typecheck(cls, cfg):
        ty = cfg["type"] if isinstance(cfg, dict) else cfg
        if ty != cls.type:
            raise ValueError(f"invalid loader type '{ty}', expected '{cls.type}'")

    def get_config(self):
        raise NotImplementedError

    def load(self, file):
        raise NotImplementedError


class GenericImageLoader(FileLoader):
    type = "generic-image"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls()

    def get_config(self):
        return self.type

    def load(self, file):
        if file is None:
            return None

        if Path(file).suffix == ".pfm":
            img = io.read_pfm(file)
        else:
            img = io.read_image_generic(file)

        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 1:
            img = np.tile(img, (1, 1, 3))
        return img


class GenericFlowLoader(FileLoader):
    """Loads flow by extension; synthesizes a valid mask from ``uvmax``."""

    type = "generic-flow"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)

        uvmax = cfg.get("uvmax") if isinstance(cfg, dict) else None
        if uvmax is None:
            uvmax = (1e3, 1e3)
        elif isinstance(uvmax, (list, tuple)):
            if len(uvmax) != 2:
                raise ValueError("uvmax must be a float or a list of two floats")
            uvmax = (float(uvmax[0]), float(uvmax[1]))
        else:
            uvmax = (float(uvmax), float(uvmax))

        return cls(uvmax)

    def __init__(self, max_uv):
        super().__init__()
        self.max_uv = max_uv

    def get_config(self):
        return {"type": self.type, "uvmax": self.max_uv}

    def load(self, file):
        if file is None:
            return None, None

        file = Path(file)
        valid = None

        if file.suffix == ".pfm":
            flow = io.read_pfm(file)[:, :, :2]
        elif file.suffix == ".flo":
            flow = io.read_flow_mb(file)
        elif file.suffix == ".png":
            flow, valid = io.read_flow_kitti(file)
        else:
            raise ValueError(f"Unsupported flow file format {file.suffix}")

        flow = flow.astype(np.float32)
        if valid is None:
            fabs = np.abs(flow)
            valid = (fabs[:, :, 0] < self.max_uv[0]) & (fabs[:, :, 1] < self.max_uv[1])

        return flow, valid


# -- registries -------------------------------------------------------------

_LAYOUTS = {cls.type: cls for cls in (GenericLayout, GenericBackwardsLayout, MultiLayout)}
_FILTERS = {cls.type: cls for cls in (CombineFilter, ExcludeFilter, FileFilter)}
_LOADERS = {cls.type: cls for cls in (GenericImageLoader, GenericFlowLoader)}


def build_layout(cfg):
    ty = cfg["type"]
    if ty not in _LAYOUTS:
        raise ValueError(f"unknown layout type '{ty}'")
    return _LAYOUTS[ty].from_config(cfg)


def build_filter(path, cfg):
    if cfg is None:
        return None
    ty = cfg["type"]
    if ty not in _FILTERS:
        raise ValueError(f"unknown filter type '{ty}'")
    return _FILTERS[ty].from_config(path, cfg)


def build_loader(cfg):
    ty = cfg["type"] if isinstance(cfg, dict) else cfg
    if ty not in _LOADERS:
        raise ValueError(f"unknown loader type '{ty}'")
    return _LOADERS[ty].from_config(cfg)
