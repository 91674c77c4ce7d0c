"""splink_tpu_torch's public surface against splink_tpu's, read with ``ast``.

Nothing is imported: both packages' sources are parsed, so the whole file
runs in milliseconds. One case per module file of ``splink_tpu/``: every
public top-level function, class and assigned constant, every public method
and property of a public class, and every ``__all__`` entry of the
reference module has a counterpart in the port module of the same path (a
definition, an import or an ``__all__`` entry, as the reference has it).
One case per CLI: every subcommand, and every option string under it, of
the reference's parser is in the port's. The port may have more than the
reference (``--device``, ``_device.py``, ``compile_stats``, ``SITES``...);
that direction is not checked.

A name with no counterpart stands in ``NO_COUNTERPART`` with its reason,
keyed ``"<module path>:<name>"`` (``<Class>.<member>`` for a member; the
module path alone for a module file with no counterpart). The last case
holds the table to the code: each entry must still name a gap that exists,
so a name ported later must leave the table in the same change.

When the reference gains a public name, port it; only a name whose meaning
is JAX's or XLA's alone, or a difference that ROADMAP.md records, goes into
the table instead.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "splink_tpu")
PORT = os.path.join(ROOT, "splink_tpu_torch")

_JIT = "builds a jax.jit closure; the port runs the same body eagerly"
_SINGLE = ("a per-pair function that jax.vmap batches; the port's functions "
           "take the batch axis directly")
_VMAPPED = ("the reference's vmapped pure-JAX path beside the Pallas kernel; "
            "the port's batched function picks the CUDA kernel or the plain "
            "version by the tensor's device")
_LINT_RULES = ("JAX hazards; the port's rules are distributed, dtypes, "
               "host_calls and import_time (analysis/rules/)")

NO_COUNTERPART = {
    # module files
    "ops/strings_pallas.py":
        "the TPU's Pallas kernels; their counterparts are ops/strings_cuda.py "
        "and the hand-written CUDA in csrc/",
    "analysis/jaxlint.py": "the JAX lint engine; its counterpart is analysis/torchlint.py",
    "analysis/rules/control_flow.py": "Python control flow on traced values: " + _LINT_RULES,
    "analysis/rules/donation.py": "buffer donation to jit: " + _LINT_RULES,
    "analysis/rules/recompile.py": "jit recompilation: " + _LINT_RULES,
    # jit factories and their caches
    "blocking_device.py:make_bucket_csr_fn": _JIT,
    "blocking_device.py:make_chunk_digest_compact_fn": _JIT,
    "blocking_device.py:make_chunk_digest_fn": _JIT,
    "blocking_device.py:make_pair_emit_fn": _JIT,
    "blocking_device.py:make_segment_sort_fn": _JIT,
    "serve/engine.py:make_candidate_gather_fn": _JIT,
    "serve/engine.py:make_encode_query_fn": _JIT,
    "serve/engine.py:make_score_fused_fn": _JIT,
    "serve/engine.py:make_score_topk_fn": _JIT,
    "approx/minhash.py:make_gram_df_fn": _JIT,
    "approx/minhash.py:make_minhash_fn": _JIT,
    "approx/lsh.py:make_verify_fn": _JIT,
    "blocking_device.py:DeviceBlockPlan.kernel_cache":
        "jitted kernels kept by closure identity so jax.jit does not retrace",
    "pairgen.py:RulePlan.kernel_cache":
        "jitted kernels kept by closure identity so jax.jit does not retrace",
    # vmapped forms and per-pair singles
    "ops/strings.py:jaro_winkler_single": _SINGLE,
    "ops/strings.py:jaro_winkler_bitmask_single": _SINGLE,
    "ops/strings.py:levenshtein_single": _SINGLE,
    "ops/strings.py:levenshtein_ratio_single": _SINGLE,
    "ops/strings.py:exact_equal_single": _SINGLE,
    "ops/strings.py:jaro_winkler_vmapped": _VMAPPED,
    "ops/strings.py:levenshtein_vmapped": _VMAPPED,
    "ops/strings.py:levenshtein_ratio_vmapped": _VMAPPED,
    "ops/__init__.py:jaro_winkler_single": _SINGLE,
    "ops/__init__.py:levenshtein_single": _SINGLE,
    "ops/qgram.py:qgram_jaccard_single": _SINGLE,
    "ops/qgram.py:qgram_cosine_distance_single": _SINGLE,
    "ops/qgram.py:qgram_jaccard_masked_single": _SINGLE,
    "ops/qgram.py:qgram_cosine_masked_single": _SINGLE,
    "ops/qgram.py:charset_jaccard_single": _SINGLE,
    "ops/qgram.py:charset_jaccard_masked_single": _SINGLE,
    # XLA's alone
    "serve/aot.py:serialize_executable":
        "pickles an XLA executable; the port's sidecar stores its built libraries",
    "serve/aot.py:deserialize_executable":
        "loads an XLA executable; the port's sidecar stores its built libraries",
    "utils/envfp.py:backend_target_fingerprint":
        "the jax backend's target; the port's environment_fingerprint names "
        "torch, the CPU target and the card",
    "utils/logging_utils.py:log_jaxpr": "logs a jaxpr; PyTorch runs eagerly and traces nothing",
    "obs/metrics.py:install_compile_monitor":
        "jax's compile listeners; the port counts its library builds with compile_stats",
    "obs/__init__.py:install_compile_monitor":
        "jax's compile listeners; the port counts its library builds with compile_stats",
    "analysis/trace_audit.py:KernelSpec.allow_callbacks":
        "allows io_callback primitives in a jaxpr; the port's audit counts "
        "host syncs against allow_syncs",
    # deliberate differences
    "resilience/retry.py:ensure_devices":
        "moves jax to the CPU when the accelerator fails; the port never "
        "leaves the card it was given (resilience/retry.py docstring)",
    "resilience/__init__.py:ensure_devices":
        "moves jax to the CPU when the accelerator fails; the port never "
        "leaves the card it was given (resilience/retry.py docstring)",
    "resilience/retry.py:OOM_MARKERS":
        "XLA's out-of-memory status strings; the port classifies OOM by "
        "exception type (retry.is_oom)",
    "gammas.py:PairContext.overflow_count":
        "survivor capacity, which the port does not have (ROADMAP.md, Queue 3)",
    "gammas.py:PairContext.record_overflow":
        "survivor capacity, which the port does not have (ROADMAP.md, Queue 3)",
    "gammas.py:PairContext.survivor_capacity":
        "survivor capacity, which the port does not have (ROADMAP.md, Queue 3)",
    "gammas.py:int32_histogram":
        "pins jnp.bincount's count dtype to int32 under x64; the port's "
        "pattern_histogram counts in int64",
    "gammas.py:logger": "never read in the reference's gammas.py",
    "native/__init__.py:available":
        "reports the reference's numpy fallback; the port has none, a failed "
        "build raises (native/__init__.py docstring)",
    "native/__init__.py:logger":
        "logs the numpy fallback, which the port does not have",
}

# the file that defines each CLI's parser (obs/__main__.py calls obs/cli.py's main)
CLIS = {
    "serve": "serve/__main__.py",
    "obs": "obs/cli.py",
    "analysis": "analysis/__main__.py",
}


def _parse(root, rel):
    with open(os.path.join(root, rel), encoding="utf-8") as fh:
        return ast.parse(fh.read(), filename=rel)


def _top_nodes(tree):
    """The module's top-level statements, with the bodies of top-level
    ``if`` and ``try`` blocks."""
    stack = list(reversed(tree.body))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.If, ast.Try)):
            blocks = [node.body, node.orelse, getattr(node, "finalbody", [])]
            blocks += [h.body for h in getattr(node, "handlers", [])]
            for block in reversed(blocks):
                stack.extend(reversed(block))
        else:
            yield node


def _assigned(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}


def _bindings(tree, imports=True):
    names = set()
    for node in _top_nodes(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names |= _assigned(node)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


def _classes(tree):
    return {n.name: n for n in _top_nodes(tree) if isinstance(n, ast.ClassDef)}


def _members(cls, classes):
    """A class's methods, properties and class attributes, with those of
    its bases defined in the same module."""
    names = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names |= _assigned(node)
    for base in cls.bases:
        if isinstance(base, ast.Name) and base.id in classes and base.id != cls.name:
            names |= _members(classes[base.id], classes)
    return names


def _all(tree):
    for node in _top_nodes(tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets
        ):
            return {e.value for e in node.value.elts}
    return set()


def _public(name):
    return not name.startswith("_")


def _gaps(rel):
    """Every key of the reference module ``rel`` with no counterpart in the
    port, before the table is applied."""
    if not os.path.exists(os.path.join(PORT, rel)):
        return {rel}
    ref, port = _parse(REF, rel), _parse(PORT, rel)
    port_names = _bindings(port)
    gaps = {n for n in _bindings(ref, imports=False) if _public(n) and n not in port_names}
    port_all = _all(port)
    gaps |= {n for n in _all(ref) if n not in port_all}
    ref_classes, port_classes = _classes(ref), _classes(port)
    for name, cls in ref_classes.items():
        if not _public(name) or name not in port_classes:
            continue  # a missing class is a gap of its own, above
        have = _members(port_classes[name], port_classes)
        gaps |= {f"{name}.{m}" for m in _members(cls, ref_classes) if _public(m) and m not in have}
    return {rel if g == rel else f"{rel}:{g}" for g in gaps}


REF_MODULES = sorted(
    os.path.relpath(os.path.join(d, f), REF).replace(os.sep, "/")
    for d, _, files in os.walk(REF)
    for f in files
    if f.endswith(".py")
)


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    missing = sorted(_gaps(rel) - set(NO_COUNTERPART))
    assert not missing, (
        f"splink_tpu_torch lacks the counterpart of splink_tpu/{rel}'s {missing}: "
        "port each, or add it to NO_COUNTERPART with its reason"
    )


def _cli_options(root, rel):
    """{(subcommand, option string)} of one parser file; the subcommand is
    "" for the top-level parser and None for a parser the file builds in a
    loop (those add to more than one subcommand)."""
    tree = _parse(root, rel)
    parsers = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "add_parser"):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    parsers[target.id] = node.value.args[0].value
    found = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        strings = [a.value for a in node.args
                   if isinstance(a, ast.Constant) and isinstance(a.value, str)]
        if node.func.attr == "add_parser":
            found |= {(s, None) for s in strings[:1]}
        elif node.func.attr == "add_argument" and isinstance(node.func.value, ast.Name):
            var = node.func.value.id
            sub = parsers.get(var, "" if var == "parser" else None)
            found |= {(sub, s) for s in strings if s.startswith("-")}
    return found


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_every_cli_option_has_a_counterpart(cli):
    ref = _cli_options(REF, CLIS[cli])
    port = _cli_options(PORT, CLIS[cli])
    assert ref, f"no parser found in splink_tpu/{CLIS[cli]}"
    # an option the port adds in a loop over its subparsers counts for each
    loops = {opt for sub, opt in port if sub is None and opt is not None}
    missing = sorted(
        (sub, opt) for sub, opt in ref - port
        if not (opt is not None and opt in loops)
    )
    assert not missing, f"python -m splink_tpu_torch.{cli} lacks {missing}"


def test_no_counterpart_table_is_not_stale():
    gaps = set().union(*(_gaps(rel) for rel in REF_MODULES))
    stale = sorted(set(NO_COUNTERPART) - gaps)
    assert not stale, (
        f"NO_COUNTERPART excuses {stale}, which the reference no longer has "
        "or the port now has: remove the entries"
    )
    assert all(isinstance(r, str) and r.strip() for r in NO_COUNTERPART.values())
