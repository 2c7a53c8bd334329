"""Every public name of the JAX package has a counterpart in the port.

For each JAX module the port's module of the same path (``filters/xla.py``:
``filters/torch_cuda.py``) must define every public function, class,
method and module constant, with every parameter name. What differs is
JAX idiom, and each difference names its port counterpart here, which must
exist: a new gap fails this test until it is ported or listed with its
counterpart. Read by parsing the sources (nothing imported).
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = os.path.join(ROOT, "nnstreamer_tpu"), os.path.join(ROOT, "nnstreamer_tpu_torch")
#: JAX files with a counterpart under another path; ``ops/pallas/`` is
#: ``ops/kernels/`` (its own tests), the generated protobuf module is
#: ``converters/proto_codec.py``
RENAMED = {"filters/xla.py": "filters/torch_cuda.py"}
SKIPPED = ("ops/pallas/", "converters/proto/")

#: (JAX file, JAX name or "name(param)") → the port's counterpart in the
#: same port file, "name" or "name(param)"
IDIOM = {
    ("filters/xla.py", "XLAFilter"): "TorchCudaFilter",
    ("elements/transform.py", "TensorTransform.as_jax_fn"): "TensorTransform.as_torch_fn",
    ("core/hw.py", "tpu_available"): "cuda_available",
    ("core/hw.py", "default_device"): "resolve_device",
    ("core/hw.py", "available_platforms"): "cuda_available",
    ("utils/probes.py", "tpu_smoke"): "gpu_smoke",
    ("models/zoo.py", "init_variables"): "synthesize_variables",
    ("models/causal_lm.py", "init_causal_lm(rng)"): "init_causal_lm(seed)",
    ("parallel/moe.py", "init_moe_params(rng)"): "init_moe_params(seed)",
    ("parallel/moe.py", "dp_guard(jitted)"): "dp_guard(fn)",
    ("ops/int8.py", "int8_row_sharded_matmul(axis_name)"): "int8_row_sharded_matmul(axis)",
    ("ops/int8.py", "quant_act_global(axis_name)"): "quant_act_global(axis)",
    ("parallel/mesh.py", "batch_sharding"): "make_mesh",
    ("parallel/mesh.py", "replicated"): "broadcast",
    ("parallel/mesh.py", "local_batch_multiple"): "axis_size",
    ("parallel/tp_decode.py", "tp_param_specs"): "tp_shard_params",
    ("parallel/tp_decode.py", "strip_device_leaves"): "tp_shard_params",
    ("parallel/tp_prefill.py", "tp_prefill_seq"): "tp_prefill_window",
    ("parallel/composite.py", "composite_query_retry_check(bundle)"):
        "composite_query_retry_check(oracle)",
    ("parallel/composite.py", "composite_query_retry_check(served)"):
        "composite_query_retry_check(spec)",
    ("parallel/composite.py", "composite_sharded_query_check(bundle)"):
        "composite_sharded_query_check(oracle)",
    ("parallel/composite.py", "composite_sharded_query_check(served)"):
        "composite_sharded_query_check(spec)",
}


def _params(f):
    a = f.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def public_names(path):
    """{name: parameter names or None} of a module's public surface."""
    out = {}
    for n in ast.parse(open(path).read()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not n.name.startswith("_"):
                out[n.name] = _params(n)
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            out[n.name] = None
            for m in n.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                        (not m.name.startswith("_") or m.name == "__init__"):
                    out[f"{n.name}.{m.name}"] = _params(m)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out[t.id] = None
    return out


def jax_files():
    for root, _, files in os.walk(JAX):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(root, f), JAX).replace(os.sep, "/")
            if f.endswith(".py") and not rel.startswith(SKIPPED):
                yield rel


def gaps(rel):
    jn = public_names(os.path.join(JAX, rel))
    tn = public_names(os.path.join(PORT, RENAMED.get(rel, rel)))
    out = []
    for name, params in jn.items():
        if name not in tn:
            out.append(name)
        elif params is not None and tn[name] is not None:
            out += [f"{name}({p})" for p in params
                    if p not in tn[name] and p not in ("self", "cls")]
    return out, tn


@pytest.mark.parametrize("rel", sorted(jax_files()))
def test_every_public_name_has_a_counterpart(rel):
    assert os.path.isfile(os.path.join(PORT, RENAMED.get(rel, rel))), rel
    missing, tn = gaps(rel)
    for gap in missing:
        key = (rel, gap) if (rel, gap) in IDIOM else (rel, gap.split(".")[0])
        assert key in IDIOM, f"{rel}: {gap} has no counterpart in the port"
        name, _, param = IDIOM[key].partition("(")
        assert name in tn, f"{rel}: {gap}'s counterpart {IDIOM[key]} is not defined"
        if param:
            assert param.rstrip(")") in tn[name], IDIOM[key]


def test_the_idiom_list_has_no_stale_entry():
    found = {(rel, g) for rel in jax_files() for g in gaps(rel)[0]}
    found |= {(rel, g.split(".")[0]) for rel, g in found}
    assert set(IDIOM) <= found
