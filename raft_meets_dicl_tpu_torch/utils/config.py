"""Config load/store utilities.

YAML or JSON is selected by file extension; loading preserves key order and
storing YAML keeps insertion order (parity with reference
src/utils/config.py:17-60). Every layer of the framework round-trips through
``from_config`` / ``get_config`` — this module is the single place files are
touched.
"""

import json
from pathlib import Path

import yaml


class _OrderedDumper(yaml.SafeDumper):
    pass


def _dict_representer(dumper, data):
    return dumper.represent_mapping(yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, data.items())


_OrderedDumper.add_representer(dict, _dict_representer)


def load(path):
    """Load a YAML/JSON config file (by extension) into plain dicts/lists."""
    path = Path(path)

    with open(path, "r") as fd:
        if path.suffix in (".yaml", ".yml"):
            return yaml.safe_load(fd)
        elif path.suffix == ".json":
            return json.load(fd)
        else:
            # default to YAML, it is a JSON superset
            return yaml.safe_load(fd)


def store(path, cfg):
    """Store a config to a YAML/JSON file (by extension), preserving order."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    with open(path, "w") as fd:
        if path.suffix == ".json":
            json.dump(cfg, fd, indent=2)
        else:
            yaml.dump(cfg, fd, Dumper=_OrderedDumper, default_flow_style=False, sort_keys=False)


def to_string(cfg, fmt="json"):
    if fmt == "json":
        return json.dumps(cfg, indent=2)
    return yaml.dump(cfg, Dumper=_OrderedDumper, default_flow_style=False, sort_keys=False)


def resolve_path(base_file, rel):
    """Resolve ``rel`` relative to the directory of the referencing config file.

    The config corpus is a graph of files referencing each other by relative
    path (reference src/data/config.py:45-57, src/strategy/config.py:8-40);
    paths always resolve relative to the *referencing* file.
    """
    rel = Path(rel)
    if rel.is_absolute():
        return rel
    return (Path(base_file).parent / rel).resolve()
