"""Weights into and out of the port's YOLO module.

Out: `to_jax_params` (a state dict -> the JAX-layout tree),
`train_state_to_jax` / `train_state_from_jax`, which carry a whole train
state (params, momentum, accumulated gradients, step, EMA) between the
port and the JAX package's tree layout, the payload of a `.ckpt` file,
and `export_reference_state_dict` / `export_ultralytics_state_dict` /
`save_torch_checkpoint`, which write unfolded weights in the reference's
or Ultralytics' torch naming (the inverses of the importers below).

In, three sources:
  * `from_jax_params`: a JAX-layout param tree of numpy arrays (what
    `tpu_yolo` and `models.yolov11.init_params` build, and what `.ckpt`
    files hold) -> a state dict. A key is the tree path joined with dots;
    conv kernels go from HWIO to OIHW.
  * `convert_state_dict`: a torch state dict in the reference's naming
    (net.p1.0.conv.weight, ...) or Ultralytics' YOLO11 naming
    (model.0.conv.weight, ..., model.23.cv2/cv3) -> a state dict.
  * `load_torch_state_dict`: .pt / .npz files, including pickled module
    trees whose classes are not importable (stub classes, scavenged).
  * `load_partial`: a shape-matched partial load for transfer learning,
    with a report of what was loaded, skipped and left.

Every mapping is exact and coverage is asserted at 100% both ways: an
unused source tensor or an unfilled destination raises. The key tables
are copies of the JAX package's `tpu_yolo/io/weights.py`.
"""
from __future__ import annotations

import pickle
import re

import numpy as np
import torch

from tpu_yolo_torch.io.checkpoint import load_checkpoint

# ---------------------------------------------------------------------------
# Raw tensor extraction from torch files.
# ---------------------------------------------------------------------------


class _StubUnpickler(pickle.Unpickler):
    """Unpickler that fabricates bare classes for unimportable modules so
    pickled nn.Module trees can be loaded structurally (their __dict__ is
    restored onto a stub) and scavenged for tensors."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (), {"__module__": module})


class _StubPickleModule:
    Unpickler = _StubUnpickler
    # torch.load probes these attributes:
    load = staticmethod(pickle.load)
    loads = staticmethod(pickle.loads)
    dumps = staticmethod(pickle.dumps)
    UnpicklingError = pickle.UnpicklingError


def _scavenge_state_dict(obj, prefix="", out=None):
    """Walk a (possibly stub-class) module tree collecting parameter and
    buffer tensors by dotted name, mirroring nn.Module.state_dict()."""
    out = {} if out is None else out
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return out
    for name, t in (d.get("_parameters") or {}).items():
        if t is not None:
            out[prefix + name] = t
    for name, t in (d.get("_buffers") or {}).items():
        if t is not None:
            out[prefix + name] = t
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            _scavenge_state_dict(child, prefix + name + ".", out)
    return out


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Read a torch .pt / .npz file into {name: float32 numpy array}."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k], dtype=np.float32) for k in z.files}

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        obj = torch.load(path, map_location="cpu", weights_only=False,
                         pickle_module=_StubPickleModule)

    # Checkpoint dict wrappers: {'model': ..., 'ema': ..., 'state_dict': ...}
    if isinstance(obj, dict):
        for key in ("ema", "model", "state_dict"):
            if key in obj and obj[key] is not None:
                obj = obj[key]
                break

    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict()
    elif not isinstance(obj, dict):
        obj = _scavenge_state_dict(obj)

    out = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().to(torch.float32).numpy()
        out[k] = np.asarray(v, dtype=np.float32)
    return out


# ---------------------------------------------------------------------------
# Name translation: source key -> JAX tree path ("net/p1/0/w"), or None to
# skip the key.
# ---------------------------------------------------------------------------

_LEAF_MAP = {
    "conv.weight": "w",
    "norm.weight": "gamma",
    "norm.bias": "beta",
    "norm.running_mean": "mean",
    "norm.running_var": "var",
    "bn.weight": "gamma",
    "bn.bias": "beta",
    "bn.running_mean": "mean",
    "bn.running_var": "var",
    "weight": "w",      # plain conv
    "bias": "b",
}

# Ultralytics DetectionModel layer index -> our subtree (YOLO11 graph order;
# 11/12/14/15/18/21 are param-free Upsample/Concat layers).
_ULTRA_LAYERS = {
    "0": "net/p1/0", "1": "net/p2/0", "2": "net/p2/1", "3": "net/p3/0",
    "4": "net/p3/1", "5": "net/p4/0", "6": "net/p4/1", "7": "net/p5/0",
    "8": "net/p5/1", "9": "net/p5/2", "10": "net/p5/3",
    "13": "fpn/h1", "16": "fpn/h2", "17": "fpn/h3", "19": "fpn/h4",
    "20": "fpn/h5", "22": "fpn/h6", "23": "head",
}

# Detect-head submodule translation: cv2 = box branch, cv3 = cls branch.
_ULTRA_HEAD = [
    (re.compile(r"^cv2\.(\d)\.([01])\."), r"box/\1/\2/"),
    (re.compile(r"^cv2\.(\d)\.2\."), r"box/\1/2/"),
    (re.compile(r"^cv3\.(\d)\.0\.0\."), r"cls/\1/0/"),
    (re.compile(r"^cv3\.(\d)\.0\.1\."), r"cls/\1/1/"),
    (re.compile(r"^cv3\.(\d)\.1\.0\."), r"cls/\1/2/"),
    (re.compile(r"^cv3\.(\d)\.1\.1\."), r"cls/\1/3/"),
    (re.compile(r"^cv3\.(\d)\.2\."), r"cls/\1/4/"),
]


def _split_leaf(rest: str):
    """Split the trailing module-leaf suffix and return (stem, our-leaf)."""
    for suffix, leaf in _LEAF_MAP.items():
        if rest.endswith("." + suffix):
            return rest[: -len(suffix) - 1], leaf
        if rest == suffix:
            return "", leaf
    return None, None


def _translate_reference_key(key: str):
    """reference module names -> our path, or None to skip."""
    if "num_batches_tracked" in key or key.startswith("head.dfl"):
        return None
    stem, leaf = _split_leaf(key)
    if leaf is None:
        raise KeyError(f"unrecognized reference key: {key}")

    # PSA region: net.p5.3.res_m.N.{conv1->attn{qkv,pe,proj}, conv2->ffn}.
    m = re.match(r"^net\.p5\.3\.res_m\.(\d+)\.(.*)$", stem)
    if m:
        idx, rest = m.groups()
        rest = re.sub(r"^conv1\.qkv$", "attn.qkv", rest)
        rest = re.sub(r"^conv1\.conv1$", "attn.pe", rest)
        rest = re.sub(r"^conv1\.conv2$", "attn.proj", rest)
        rest = re.sub(r"^conv2\.([01])$", r"ffn.\1", rest)
        stem = f"net.p5.3.m.{idx}.{rest}"
    stem = stem.replace(".res_m.", ".m.")
    return stem.replace(".", "/") + "/" + leaf


def _translate_ultralytics_key(key: str):
    """ultralytics YOLO11 names -> our path, or None to skip."""
    if "num_batches_tracked" in key:
        return None
    key = key.removeprefix("model.")
    layer, _, rest = key.partition(".")
    if layer not in _ULTRA_LAYERS:
        raise KeyError(f"unmapped ultralytics layer in key: {key}")
    base = _ULTRA_LAYERS[layer]

    if base == "head":
        if rest.startswith("dfl."):
            return None
        for pat, repl in _ULTRA_HEAD:
            if pat.match(rest):
                rest = pat.sub(repl, rest)
                break
        else:
            raise KeyError(f"unmapped head key: {key}")
        stem, leaf = _split_leaf(rest.replace("/", "."))
        if leaf is None:
            raise KeyError(f"unrecognized head leaf: {key}")
        return "head/" + stem.replace(".", "/") + "/" + leaf

    stem, leaf = _split_leaf(rest)
    if leaf is None:
        raise KeyError(f"unrecognized leaf: {key}")
    stem = stem.replace("cv1", "conv1").replace("cv2", "conv2").replace("cv3", "conv3")
    stem = stem.replace(".", "/")
    return f"{base}/{stem}/{leaf}" if stem else f"{base}/{leaf}"


def _detect_format(names) -> str:
    for n in names:
        if n.startswith(("net.", "fpn.", "head.")):
            return "reference"
        if re.match(r"^(model\.)?\d+\.", n):
            return "ultralytics"
    raise ValueError("cannot detect checkpoint format from key names")


# ---------------------------------------------------------------------------
# State-dict assembly.
# ---------------------------------------------------------------------------


def _check_coverage(state: dict, template: dict) -> None:
    missing = sorted(set(template) - set(state))
    if missing:
        raise ValueError(f"{len(missing)} destination weights not filled, "
                         f"e.g. {missing[:8]}")
    extra = sorted(set(state) - set(template))
    if extra:
        raise KeyError(f"{len(extra)} source weights have no destination, "
                       f"e.g. {extra[:8]}")
    for key, t in state.items():
        if tuple(t.shape) != tuple(template[key].shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != expected "
                             f"{tuple(template[key].shape)}")


def _tree_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, (*prefix, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, (*prefix, str(i)))
    else:
        yield prefix, tree


def _leaf_dtype(name: str):
    """The numpy dtype of a weight: int8 for a quantized kernel (`w_q`),
    float32 for everything else."""
    return np.int8 if name == "w_q" else np.float32


def from_jax_params(params, cfg) -> dict[str, torch.Tensor]:
    """JAX-layout param tree (numpy leaves, HWIO kernels; folded, not, or
    int8-quantized) -> the port's state dict for `cfg` on the CPU: `w_q`
    int8, every other leaf float32 (`s_in` 0-d). Raises unless the tree
    fills every weight of the model and nothing else."""
    from tpu_yolo_torch.models.yolov11 import YOLO

    state = {}
    for path, leaf in _tree_items(params):
        a = np.asarray(leaf, dtype=_leaf_dtype(path[-1]))
        if path[-1] in ("w", "w_q") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        state[".".join(path)] = torch.from_numpy(np.array(a))
    _check_coverage(state, YOLO.shaped_like(cfg, state).state_dict())
    return state


def to_jax_params(state_dict) -> dict:
    """The inverse of `from_jax_params`: a model or a state dict (name ->
    tensor or array) -> the JAX-layout tree of numpy arrays, int8 for
    `w_q` and float32 otherwise (nested dicts, lists where the keys are
    indices, conv kernels OIHW -> HWIO)."""
    if isinstance(state_dict, torch.nn.Module):
        state_dict = state_dict.state_dict()
    root: dict = {}
    for name, t in state_dict.items():
        path = name.split(".")
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu()
            t = t if t.dtype == torch.int8 else t.float()
        a = np.asarray(t, dtype=_leaf_dtype(path[-1]))
        if path[-1] in ("w", "w_q") and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(a, order="C")  # (ascontiguousarray makes a 0-d s_in 1-d)

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def train_state_to_jax(state) -> dict:
    """A `train.step.TrainState` -> the JAX package's train state as numpy
    trees: {'params', 'opt': {'momentum'[, 'accum']}, 'step',
    'ema_updates', 'ema_params'}. The JAX package keeps momentum and
    accumulation leaves for the BN running statistics too (never
    touched): they are written as zeros.

    A state split over the model axis (parallel/tensor.py) is gathered
    first, so the trees are those one process would write: a collective
    over the model group, so call it on every rank. (A split model takes
    a whole state through `DataParallel.shard_model_parallel` after
    `train_state_from_jax`, or `tensor.shard_state`.)"""
    from tpu_yolo_torch.parallel import tensor

    if tensor.is_sharded(state.model):
        state = tensor.gather_state(state)
    sd = state.model.state_dict()

    def full(per_param):
        return to_jax_params({n: per_param[n] if n in per_param
                              else torch.zeros_like(t) for n, t in sd.items()})

    opt = {"momentum": full(state.momentum)}
    if state.accum is not None:
        opt["accum"] = full(state.accum)
    return {"params": to_jax_params(sd), "opt": opt,
            "step": np.asarray(state.step, np.int32),
            "ema_updates": np.asarray(state.ema_updates, np.int32),
            "ema_params": None if state.ema is None else to_jax_params(state.ema)}


def train_state_from_jax(tree: dict, cfg, device="cpu", accumulate: int = 1):
    """The inverse: a JAX train state (numpy trees, as a `.ckpt` holds it)
    -> a `TrainState` on `device`. `accumulate` > 1 gives the state its
    accumulation buffers, from the tree when it has them, else zeros."""
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.train.step import init_train_state

    model = YOLO.from_state_dict(cfg, from_jax_params(tree["params"], cfg))
    model = model.to(device=device, memory_format=torch.channels_last)
    state = init_train_state(model, ema=tree.get("ema_params") is not None,
                             accumulate=accumulate)

    def fill(dst, src_tree):
        src = from_jax_params(src_tree, cfg)
        with torch.no_grad():
            for n, t in dst.items():
                t.copy_(src[n])

    fill(state.momentum, tree["opt"]["momentum"])
    if state.accum is not None and "accum" in tree["opt"]:
        fill(state.accum, tree["opt"]["accum"])
    if state.ema is not None:
        fill(state.ema, tree["ema_params"])
    state.step = int(tree["step"])
    state.ema_updates = int(tree["ema_updates"])
    return state


def convert_state_dict(state: dict[str, np.ndarray], cfg,
                       source_format: str | None = None):
    """Reference- or Ultralytics-named torch state dict (numpy arrays,
    OIHW) -> the port's unfolded state dict for `cfg`, with 100% coverage
    asserted both ways."""
    source_format = source_format or _detect_format(state.keys())
    translate = (_translate_reference_key if source_format == "reference"
                 else _translate_ultralytics_key)
    out = {}
    for src_key, tensor in state.items():
        path = translate(src_key)
        if path is None:
            continue
        key = path.replace("/", ".")
        if key in out:
            raise KeyError(f"{src_key} -> {key}: filled twice")
        out[key] = torch.from_numpy(np.array(tensor, dtype=np.float32))
    from tpu_yolo_torch.models.yolov11 import model_class

    _check_coverage(out, model_class(cfg)(cfg).state_dict())
    return out


def load_partial(state: dict[str, np.ndarray], template,
                 source_format: str | None = None):
    """Shape-matched partial load for transfer learning (the JAX
    package's `load_partial`, e.g. a COCO backbone under a new
    num_classes head). `state` is a reference- or Ultralytics-named torch
    state dict (numpy arrays, OIHW); `template` a YOLO or its state dict.
    Coverage is not asserted: returns (state dict, report), the state
    dict float32 copies of the template's tensors with every matched one
    replaced, the report listing 'loaded' keys, 'skipped_shape' (source
    key, source shape, destination shape; OIHW), 'unmapped' source keys
    (names neither layout knows, e.g. of another model family) and
    'missing' keys (sorted). Keys are the port's."""
    source_format = source_format or _detect_format(state.keys())
    translate = (_translate_reference_key if source_format == "reference"
                 else _translate_ultralytics_key)
    if isinstance(template, torch.nn.Module):
        template = template.state_dict()
    out = {k: t.detach().cpu().float().clone() for k, t in template.items()}
    report = {"loaded": [], "skipped_shape": [], "unmapped": [], "missing": []}
    for src_key, tensor in state.items():
        try:
            path = translate(src_key)
        except KeyError:
            report["unmapped"].append(src_key)
            continue
        key = path and path.replace("/", ".")
        if key not in out:
            continue
        if tuple(tensor.shape) != tuple(out[key].shape):
            report["skipped_shape"].append(
                (src_key, tuple(tensor.shape), tuple(out[key].shape)))
            continue
        out[key] = torch.from_numpy(np.array(tensor, dtype=np.float32))
        report["loaded"].append(key)
    report["missing"] = sorted(set(out) - set(report["loaded"]))
    return out, report


# ---------------------------------------------------------------------------
# Inverse direction: the port's state dict -> torch-layout state dicts.
# ---------------------------------------------------------------------------

# the head's cls stage index -> Ultralytics cv3 submodule path
_ULTRA_CLS_STAGE = {"0": "0.0", "1": "0.1", "2": "1.0", "3": "1.1", "4": "2"}
_ULTRA_LAYER_OF = {v: k for k, v in _ULTRA_LAYERS.items() if v != "head"}


def _module_groups(state) -> dict:
    """{module path tuple: {leaf name: float32 numpy array}} over a state
    dict (or a model's), in its key order."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    out = {}
    for key, t in state.items():
        *mod, leaf = key.split(".")
        out.setdefault(tuple(mod), {})[leaf] = np.array(
            t.detach().cpu().float() if isinstance(t, torch.Tensor) else t,
            dtype=np.float32)
    return out


def _emit_module(state, name, leaves, *, bn_prefix):
    """Write one module's leaves under torch naming (OIHW kernels, as the
    port keeps them)."""
    is_conv_bn = "gamma" in leaves
    for leaf, val in leaves.items():
        if leaf == "w":
            state[f"{name}.conv.weight" if is_conv_bn else f"{name}.weight"] = val
        elif leaf == "b":
            state[f"{name}.bias"] = val
        else:
            torch_leaf = {"gamma": "weight", "beta": "bias",
                          "mean": "running_mean", "var": "running_var"}[leaf]
            state[f"{name}.{bn_prefix}.{torch_leaf}"] = val
    if is_conv_bn:
        state[f"{name}.{bn_prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _check_unfolded(groups):
    if not any("gamma" in leaves for leaves in groups.values()):
        raise ValueError("export needs unfolded (gamma/beta/mean/var) "
                         "weights; folded ones lost the BN statistics")


def export_reference_state_dict(state, cfg) -> dict[str, np.ndarray]:
    """The port's unfolded state dict (or model) -> a reference-layout
    torch state dict (numpy, OIHW): Conv = conv + norm, residual lists as
    res_m, the PSA block's attention as conv1.{qkv,conv1,conv2} and its
    feed-forward as conv2.N, plus the fixed DFL expectation conv that the
    importer skips. The inverse of `_translate_reference_key`: it round-
    trips bit for bit through convert_state_dict(source_format="reference")."""
    groups = _module_groups(state)
    _check_unfolded(groups)
    out = {}
    for mod_path, leaves in groups.items():
        stem = ".".join(mod_path).replace(".m.", ".res_m.")
        stem = re.sub(
            r"^(net\.p5\.3\.res_m\.\d+)\.(.*)$",
            lambda m: m.group(1) + "." + m.group(2)
            .replace("attn.qkv", "conv1.qkv")
            .replace("attn.pe", "conv1.conv1")
            .replace("attn.proj", "conv1.conv2")
            .replace("ffn.", "conv2."),
            stem)
        _emit_module(out, stem, leaves, bn_prefix="norm")
    out["head.dfl.conv.weight"] = np.arange(
        cfg.reg_max, dtype=np.float32).reshape(1, cfg.reg_max, 1, 1)
    return out


def export_ultralytics_state_dict(state, cfg) -> dict[str, np.ndarray]:
    """The port's unfolded state dict (or model) -> an Ultralytics
    YOLO11-layout state dict (model.N... keys, numpy, OIHW), so weights
    trained by the port go back to that ecosystem
    (`YOLO("yolo11n.yaml").model.load_state_dict(...)`). The inverse of
    `_translate_ultralytics_key`: it round-trips bit for bit through
    convert_state_dict(source_format="ultralytics")."""
    groups = _module_groups(state)
    _check_unfolded(groups)
    out = {}
    for mod_path, leaves in groups.items():
        if mod_path[0] == "head":
            branch, scale, stage = mod_path[1], mod_path[2], mod_path[3]
            if branch == "box":
                name = f"model.23.cv2.{scale}.{stage}"
            else:
                name = f"model.23.cv3.{scale}.{_ULTRA_CLS_STAGE[stage]}"
        else:
            net = mod_path[0] == "net"
            layer = "/".join(mod_path[:3] if net else mod_path[:2])
            parts = ["cv" + seg[-1] if seg in ("conv1", "conv2", "conv3")
                     else seg for seg in mod_path[3 if net else 2:]]
            name = ".".join(["model", _ULTRA_LAYER_OF[layer], *parts])
        _emit_module(out, name, leaves, bn_prefix="bn")
    out["model.23.dfl.conv.weight"] = np.arange(
        cfg.reg_max, dtype=np.float32).reshape(1, cfg.reg_max, 1, 1)
    return out


def save_torch_checkpoint(path: str, state, cfg,
                          target_format: str = "ultralytics"):
    """Write a .pt that torch.load (and `load_torch_state_dict`) reads:
    {"state_dict": {...}, "format": target_format}, in the Ultralytics or
    the reference layout."""
    export = (export_ultralytics_state_dict if target_format == "ultralytics"
              else export_reference_state_dict)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export(state, cfg).items()}
    torch.save({"state_dict": sd, "format": target_format}, path)


def load_checkpoint_params(path: str, cfg, source_format: str | None = None):
    """One-call load: torch/npz file -> the port's state dict for `cfg`."""
    return convert_state_dict(load_torch_state_dict(path), cfg, source_format)


def load_params(path: str, cfg) -> dict[str, torch.Tensor]:
    """The port's state dict for `cfg` from a weights file: a `.ckpt` of
    either package (its EMA weights when it has them, else its params),
    or a reference / Ultralytics torch file or `.npz`."""
    if path.endswith(".ckpt"):
        payload = load_checkpoint(path)
        return from_jax_params(payload.get("ema_params") or payload["params"], cfg)
    return load_checkpoint_params(path, cfg)
