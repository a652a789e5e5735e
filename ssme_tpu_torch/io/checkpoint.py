"""Checkpoint / resume of the port's PMMH chains, and the bridge from JAX.

``save_checkpoint`` writes a ``PMMHState`` (tensors, iteration counter
and every chain generator's state) atomically to one ``.npz``;
``load_checkpoint`` restores it on a device, so ``run_from`` resumes
bit-exactly.

``state_from_jax`` / ``load_jax_checkpoint`` carry a chain started in JAX
over to the port: they read a JAX ``PMMHState`` as
``ssme_tpu.io.save_checkpoint`` writes it (leaves ``leaf_0``..``leaf_8``
in the field order trans_theta, log_like, log_prior, mean, sigma_hat, ct,
accept_ma, iteration, key; the key as uint32 key data (C, 2)).  Each
chain's two key words become its generator's 64-bit seed.  Only numpy is
needed to read the file.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Tuple

import numpy as np
import torch

from ssme_tpu_torch.inference.pmmh import PMMHState, generator_from_seed

_TENSOR_FIELDS = ("trans_theta", "log_like", "log_prior", "mean",
                  "sigma_hat", "ct", "accept_ma")


def _write_npz(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_checkpoint(path: str, state: PMMHState, metadata: dict = None
                    ) -> None:
    """Atomically save a PMMHState plus JSON-able metadata."""
    payload = {f: getattr(state, f).detach().cpu().numpy()
               for f in _TENSOR_FIELDS}
    payload["iteration"] = np.asarray(state.iteration, np.int64)
    payload["generators"] = np.stack(
        [g.get_state().numpy() for g in state.generators])
    payload["__meta__"] = np.frombuffer(
        json.dumps({"metadata": metadata or {}}).encode(), dtype=np.uint8)
    _write_npz(path, payload)


def load_checkpoint(path: str, device="cpu") -> Tuple[PMMHState, dict]:
    """Load a checkpoint written by :func:`save_checkpoint`; returns
    (state, metadata) with tensors and generators on ``device``."""
    device = torch.device(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        fields = {f: torch.as_tensor(data[f], device=device)
                  for f in _TENSOR_FIELDS}
        iteration = int(data["iteration"])
        gen_states = data["generators"]
    gens = []
    for s in gen_states:
        g = torch.Generator(device=device)
        g.set_state(torch.as_tensor(s, dtype=torch.uint8))
        gens.append(g)
    return (PMMHState(**fields, iteration=iteration, generators=tuple(gens)),
            meta["metadata"])


def state_from_jax(leaves, device="cpu") -> PMMHState:
    """A JAX ``PMMHState`` (its nine leaves as arrays, key as uint32 key
    data (C, 2)) as the port's state on ``device``."""
    if len(leaves) != 9:
        raise ValueError(f"expected the 9 PMMHState leaves, got {len(leaves)}")
    device = torch.device(device)
    tensors = {f: torch.as_tensor(np.asarray(leaf, np.float32), device=device)
               for f, leaf in zip(_TENSOR_FIELDS, leaves[:7])}
    key = np.asarray(leaves[8]).astype(np.uint64)
    if key.ndim != 2 or key.shape[1] != 2:
        raise ValueError(f"key data must be (C, 2), got {key.shape}")
    gens = tuple(generator_from_seed((int(k0) << 32) | int(k1), device)
                 for k0, k1 in key)
    return PMMHState(**tensors, iteration=int(np.asarray(leaves[7])),
                     generators=gens)


def load_jax_checkpoint(path: str, device="cpu") -> Tuple[PMMHState, dict]:
    """Read a checkpoint written by ``ssme_tpu.io.save_checkpoint`` of a
    JAX ``PMMHState``; returns (state, metadata)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    return state_from_jax(leaves, device=device), meta.get("metadata", {})


__all__ = ["save_checkpoint", "load_checkpoint", "state_from_jax",
           "load_jax_checkpoint"]
