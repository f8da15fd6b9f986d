"""The `.ckpt` checkpoint format of `tpu_yolo`: a pickled dict of plain
numpy trees in the JAX layout (nested dicts and lists, HWIO kernels),
loadable without JAX or torch. The port reads and writes the same
payloads, so either package resumes from a file the other wrote
(io/weights.py carries the trees to and from the port's state).

A training checkpoint holds {'epoch', 'best', 'meta', 'params', 'opt':
{'momentum'[, 'accum']}, 'step', 'ema_updates', 'ema_params'};
`strip_checkpoint` keeps the (EMA) params alone, in fp16, as the file to
deploy."""
from __future__ import annotations

import pickle

import numpy as np


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def save_checkpoint(path: str, payload: dict):
    with open(path, "wb") as f:
        pickle.dump(_map_tree(np.asarray, payload), f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def strip_checkpoint(path: str):
    """Keep only (ema) params, cast floats to fp16 for a small deploy file."""
    ckpt = load_checkpoint(path)
    params = ckpt.get("ema_params") or ckpt.get("params")

    def shrink(x):
        x = np.asarray(x)
        return x.astype(np.float16) if x.dtype == np.float32 else x

    out = {"epoch": ckpt.get("epoch"), "best": ckpt.get("best"),
           "params": _map_tree(shrink, params), "meta": ckpt.get("meta")}
    with open(path, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
