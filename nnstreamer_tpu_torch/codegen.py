"""nns-new-filter-torch — custom-filter scaffolding generator.

Port of nnstreamer_tpu/codegen.py. Role equivalent of the reference's dev
tooling (tools/development/nnstreamerCodeGenCustomFilter.py, which emits a
C custom-filter skeleton + build glue). Generates a ready-to-run skeleton
for either custom-filter kind the port supports:

* ``--kind py`` (default; also ``--kind python``): a ``CustomFilter`` class
  script for ``framework=python3`` (filters/custom.py contract): numpy
  arrays in, numpy arrays or torch tensors out, run on the host;
* ``--kind c``: a C source + Makefile implementing the flat C ABI in
  native/nns_custom.h for ``framework=custom model=lib<name>.so``.

    nns-new-filter-torch myscaler --kind py --dir ./filters
    nns-launch-torch "videotestsrc ! tensor_converter ! \
                tensor_filter framework=python3 model=filters/myscaler.py \
                ! tensor_sink"
"""

from __future__ import annotations

import argparse
import os
import re
import sys

_PY_TEMPLATE = '''"""{name} — custom python3 tensor filter.

Generated by nns-new-filter-torch. Serve with:

    nns-launch-torch "... ! tensor_filter framework=python3 model={name}.py ! ..."

The class contract mirrors the reference's python3 subplugin
(tensor_filter_python3.cc:85-135): declare I/O info, implement invoke.
"""

import numpy as np


class CustomFilter:
    """Passthrough-with-scale example: edit dims/types and invoke."""

    def __init__(self, *args):
        self.scale = 1.0

    def getInputDimension(self):
        # (dims, types): comma-separated per tensor, innermost-first dims
        return "4:1", "float32"

    def getOutputDimension(self):
        return "4:1", "float32"

    def setInputDimension(self, in_info):
        # optional: accept upstream-driven shapes (a TensorsInfo); return
        # the resulting output info. Delete this method to keep the static
        # getInput/OutputDimension contract above.
        self._in = in_info
        return in_info

    def invoke(self, *arrays):
        # arrays are host numpy ndarrays (a tensor on the GPU is copied
        # down first); return one numpy array or torch tensor per output
        # tensor (a tensor is copied to the host).
        return tuple(a * self.scale for a in arrays)
'''

_C_TEMPLATE = '''/* {name} — custom C tensor filter (nns_custom.h flat ABI).
 *
 * Generated by nns-new-filter-torch. Build + serve:
 *
 *   make
 *   tensor_filter framework=custom model=./lib{name}.so
 */

#include <stdint.h>
#include <string.h>

typedef struct {{
  void *data;
  uint64_t size;
}} NnsTensor;

#define EXPORT __attribute__((visibility("default")))

EXPORT int nns_custom_get_input_info(char *dims, char *types, int cap) {{
  strncpy(dims, "4:1", cap);
  strncpy(types, "float32", cap);
  return 0;
}}

EXPORT int nns_custom_get_output_info(char *dims, char *types, int cap) {{
  strncpy(dims, "4:1", cap);
  strncpy(types, "float32", cap);
  return 0;
}}

EXPORT int nns_custom_invoke(int num_in, const NnsTensor *in,
                             int num_out, NnsTensor *out) {{
  /* example: copy input to output, scaling floats by 2 */
  int i;
  for (i = 0; i < num_in && i < num_out; i++) {{
    const float *src = (const float *) in[i].data;
    float *dst = (float *) out[i].data;
    uint64_t n = in[i].size / sizeof(float), j;
    for (j = 0; j < n; j++)
      dst[j] = src[j] * 2.0f;
  }}
  return 0;
}}
'''

# name-independent on purpose: a second `nns-new-filter-torch --kind c` in
# the same directory reuses the identical Makefile instead of colliding
_MAKEFILE = '''CC ?= gcc
CFLAGS ?= -O2 -fPIC -Wall

all: $(patsubst %.c,lib%.so,$(wildcard *.c))

lib%.so: %.c
\t$(CC) $(CFLAGS) -shared -o $@ $<

clean:
\trm -f lib*.so
'''


def generate(name: str, kind: str, out_dir: str) -> list:
    """Write the skeleton files; returns the created paths."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"filter name must be a C identifier: {name!r}")
    os.makedirs(out_dir, exist_ok=True)
    # (path, content, shared): shared files (the name-independent
    # Makefile) may already exist with identical content — a second
    # filter in the same directory reuses them; name-specific sources
    # are always refused if present (the user may have edited them)
    if kind in ("py", "python"):
        plan = [(os.path.join(out_dir, f"{name}.py"),
                 _PY_TEMPLATE.format(name=name), False)]
    elif kind == "c":
        plan = [(os.path.join(out_dir, f"{name}.c"),
                 _C_TEMPLATE.format(name=name), False),
                (os.path.join(out_dir, "Makefile"), _MAKEFILE, True)]
    else:
        raise ValueError(f"unknown kind {kind!r} (py, python or c)")
    # atomic: refuse BEFORE writing anything, never leave partial output
    for path, content, shared in plan:
        if os.path.exists(path) and not (shared and _read(path) == content):
            raise FileExistsError(f"refusing to overwrite {path}")
    created = []
    for path, content, _shared in plan:
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(content)
        created.append(path)
    return created


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nns-new-filter-torch",
        description="Generate a custom tensor_filter skeleton")
    ap.add_argument("name", help="filter name (C identifier)")
    ap.add_argument("--kind", choices=("py", "python", "c"), default="py",
                    help="py or python: python3 CustomFilter script (default); "
                         "c: nns_custom.h C source + Makefile")
    ap.add_argument("--dir", default=".", help="output directory")
    args = ap.parse_args(argv)
    try:
        for path in generate(args.name, args.kind, args.dir):
            print(path)
    except (ValueError, FileExistsError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
