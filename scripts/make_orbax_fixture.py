"""Write the orbax checkpoint fixture of the port's tests and chip smoke.

    JAX_PLATFORMS=cpu python3 scripts/make_orbax_fixture.py [--out tests/data]

Builds the JAX package's LeNet-5 (``zoo://lenet?seed=1``: 28x28x1, 10
classes, float32) and saves its variables twice with the JAX package's own
``utils/checkpoints.save_variables``: as an orbax ``StandardCheckpointer``
directory, ``orbax_lenet_seed1/``, and as flax bytes,
``lenet_seed1.msgpack``. The port reads both without JAX, orbax or flax
(tests/test_torch_orbax.py; chip_smoke.py on a machine that has none of
them) and holds the directory's leaves bit-equal to the file's. This script
imports JAX, flax and orbax; rerun it only to remake the fixture.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SPEC = "zoo://lenet?seed=1"
DIRNAME, FILENAME = "orbax_lenet_seed1", "lenet_seed1.msgpack"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("tests", "data"))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from nnstreamer_tpu.models.zoo import get_model
    from nnstreamer_tpu.utils.checkpoints import save_variables

    variables = get_model(SPEC).params
    os.makedirs(args.out, exist_ok=True)
    directory = os.path.abspath(os.path.join(args.out, DIRNAME))
    shutil.rmtree(directory, ignore_errors=True)
    save_variables(directory, variables)
    save_variables(os.path.join(args.out, FILENAME), variables)
    size = sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(directory) for f in fs)
    print(f"{SPEC}: {directory} ({size} bytes), "
          f"{os.path.join(args.out, FILENAME)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
