"""Generator for tests/golden/seeded_params.json — run once, commit the JSON.

    PYTHONPATH=src python tests/golden/gen_seeded_params.py

Freezes the 510 float32 values of `repro.core.smallnet.seeded_params()`, the
params that `sweep_golden.json` and `frame_trunk_golden.json` were made
with.  The draw comes from `jax.random`, whose bits changed when JAX made
`jax_threefry_partitionable` the default, so the draw here is taken under
`jax.threefry_partitionable(False)`: the one that reproduces both golden
files.  Each leaf is stored with its shape and its values; each float32 is
written as the float64 it widens to exactly, so it reads back to the same
float32 bits, and the PyTorch port (which imports no JAX) loads the exact
params with numpy alone.
"""
from __future__ import annotations

import json
import pathlib

import jax
import numpy as np

from repro.core import smallnet


def seeded_params_draw() -> dict:
    """The reference's seeded params as float32 numpy leaves."""
    with jax.threefry_partitionable(False):
        params = smallnet.seeded_params()
    return {layer: {leaf: np.asarray(a, np.float32) for leaf, a in leaves.items()}
            for layer, leaves in params.items()}


def main() -> None:
    params = seeded_params_draw()
    out = {
        "source": "repro.core.smallnet.seeded_params() under "
                  "jax.threefry_partitionable(False)",
        "params": {layer: {leaf: {"shape": list(a.shape),
                                  "values": [float(v) for v in a.reshape(-1)]}
                           for leaf, a in leaves.items()}
                   for layer, leaves in params.items()},
    }
    path = pathlib.Path(__file__).parent / "seeded_params.json"
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
