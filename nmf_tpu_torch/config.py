"""Hydra-style YAML config composition without hydra (the port's own copy).

Preserves the reference's config *surface* (SURVEY.md section 5): group names
(``model=microfacet_tensorf2``, ``field=tensorf``, ``dataset=lego``), dotted
overrides (``model.arch.model.anoise=0.5``), a defaults list in
``default.yaml``, and ``_target_`` strings (mapped to this package's
builders). hydra/omegaconf are not dependencies, so this is a small
self-contained reimplementation of the subset the reference uses
(train.py:904-916, configs/default.yaml).
"""
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

CONFIG_DIR = Path(__file__).parent / "configs"


def _parse_value(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _deep_update(dst: Dict, over: Dict):
    """In-place deep merge (keeps the field<->model.arch.rf aliasing that
    compose() relies on)."""
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def _set_dotted(cfg: Dict, dotted: str, value: Any):
    keys = dotted.split(".")
    d = cfg
    for k in keys[:-1]:
        nxt = d.get(k)
        if not isinstance(nxt, dict):
            # replace missing OR explicit-null intermediates (yaml
            # `visibility_module: null`) so overrides can graft subtrees
            nxt = {}
            d[k] = nxt
        d = nxt
    d[keys[-1]] = value


def load_group(group: str, name: str, config_dir: Path = None) -> Dict:
    config_dir = config_dir or CONFIG_DIR
    path = config_dir / group / f"{name}.yaml"
    with open(path) as f:
        return yaml.safe_load(f) or {}


def compose(overrides: Optional[List[str]] = None,
            config_dir: Optional[Path] = None) -> Dict:
    """Compose default.yaml + group selections + dotted overrides.

    overrides: list like ["model=microfacet_tensorf2", "dataset=lego",
    "model.arch.model.anoise=0.5", "expname=run1"].
    """
    config_dir = Path(config_dir) if config_dir else CONFIG_DIR
    overrides = list(overrides or [])
    with open(config_dir / "default.yaml") as f:
        cfg = yaml.safe_load(f)
    defaults = cfg.pop("defaults", [])

    # group selections from the defaults list, overridable on the CLI
    selections = {}
    for d in defaults:
        if isinstance(d, dict):
            for g, name in d.items():
                if g != "_self_":
                    selections[g] = name
    rest = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' must be key=value")
        k, v = ov.split("=", 1)
        if k in selections and "." not in k:
            selections[k] = v
        else:
            rest.append((k, v))

    for group, name in selections.items():
        cfg[group] = load_group(group, str(name), config_dir)

    # dual-scene training selects a second dataset with dataset2=<name>;
    # params=<name> selects a tuning preset from configs/params/ (the
    # reference's orphan configs/params/*.yaml group — not in its defaults
    # list, applied on demand). Preset files are structured override trees
    # (model:/field: subtrees) merged between the group files and the
    # dotted CLI overrides, so CLI still wins.
    rest2, params_sel = [], None
    for k, v in rest:
        if k == "dataset2":
            cfg["dataset2"] = load_group("dataset", str(v), config_dir)
        elif k == "params":
            params_sel = str(v)
        else:
            rest2.append((k, v))
    rest = rest2
    bg_upsamp = None
    if params_sel is not None:
        preset = load_group("params", params_sel, config_dir)
        # bg_upsamp applies only when the composed model has a bg module
        # (reference train.py:298-308: hasattr(params, 'bg_upsamp_res')
        # and tensorf.bg_module is not None).
        bg_upsamp = preset.pop("bg_upsamp", None)
        cfg["params_preset"] = params_sel
        _deep_update(cfg, preset)

    # the reference grafts the field config into model.arch.rf
    # (train.py:911: cfg.model.arch.rf = cfg.field)
    if "field" in cfg and "model" in cfg and "arch" in cfg.get("model", {}):
        cfg["model"]["arch"]["rf"] = cfg["field"]

    if bg_upsamp:
        bg = cfg.get("model", {}).get("arch", {}).get("bg_module")
        if isinstance(bg, dict):
            bg["bg_resolution"] = bg_upsamp["resolution"]
            bg["lr"] = bg_upsamp["lr"]

    for k, v in rest:
        _set_dotted(cfg, k, _parse_value(v))
    return _coerce_numbers(cfg)


def _coerce_numbers(x):
    """YAML 1.1 reads '8e-5' (no dot) as a string; coerce such values."""
    if isinstance(x, dict):
        return {k: _coerce_numbers(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_coerce_numbers(v) for v in x]
    if isinstance(x, str):
        try:
            f = float(x)
            return f
        except ValueError:
            return x
    return x


def save_config(cfg: Dict, path):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
