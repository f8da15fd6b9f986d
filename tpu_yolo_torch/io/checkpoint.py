"""Read the `.ckpt` checkpoints that `tpu_yolo` writes: a pickled dict of
plain numpy trees ({'epoch', 'best', 'params', 'ema_params', 'opt_state',
'step', 'ema_updates', 'meta'}), loadable without JAX."""
from __future__ import annotations

import pickle


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)
