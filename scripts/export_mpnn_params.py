"""Export the recorded Grid8x8 learning run's best MPNN parameters to numpy.

Restores the Orbax checkpoint ``runs/learning/grid8x8_tpu/checkpoints/best``
on the CPU (the checkpoint was written on a TPU, so the restore takes a
template built from its own metadata with a CPU sharding) and writes the
policy and value parameters to ``tarl_tpu_torch/weights/grid8x8_mpnn_best.npz``
as flat ``policy/params/edge_fc1/kernel``-style keys, which
``tarl_tpu_torch.convert.load_params_npz`` reads back with numpy alone.

    JAX_PLATFORMS=cpu python scripts/export_mpnn_params.py [--out PATH]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "runs", "learning", "grid8x8_tpu",
                          "checkpoints", "best")
OUT = os.path.join(REPO, "tarl_tpu_torch", "weights",
                   "grid8x8_mpnn_best.npz")


def restore_params(path: str = CHECKPOINT) -> dict:
    """The checkpoint's ``params`` tree ({"policy": ..., "value": ...}) as
    nested dicts of numpy arrays, restored on the CPU."""
    import jax
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    with ocp.StandardCheckpointer() as ckptr:
        meta = ckptr.metadata(path)
        tree = meta.item_metadata.tree
        template = jax.tree.map(
            lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu),
            tree)
        restored = ckptr.restore(path, template)
    return jax.tree.map(np.asarray, restored["params"])


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=CHECKPOINT)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    flat = flatten(restore_params(args.checkpoint))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **flat)
    for k, v in sorted(flat.items()):
        print(f"{k} {v.shape} {v.dtype}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
