"""JL001 / JL003: host-library calls and host syncs on device values.

Inside device code, ``np.sum(t)`` or ``math.exp(t)`` on a card tensor
copies it to the host implicitly (``__array__`` / ``__float__``), waits
for the stream, and computes on the host. ``float(t)``, ``t.item()``,
``t.cpu()`` block until the card catches up: in a hot path a full pipeline
stall per call. ``torch.tensor(host, device=card)`` copies host data onto
the card, and the copy waits for the stream too. This rule is the static
side of the trace audit's ``allow_syncs`` counts. Both rules fire only in
device code (:data:`~..torchlint.DEVICE_ROOTS` and their callees) and only
when an argument provably holds a device value, so host-side set-up stays
silent.
"""

from __future__ import annotations

import ast

from . import rule

# numpy.asarray / numpy.array are host syncs (JL003's subject), not host
# compute: the two rules stay disjoint, one hazard per finding
_SYNC_NP = {"numpy.asarray", "numpy.array"}
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_UPLOAD_CTORS = {"torch.tensor", "torch.as_tensor"}


def _after_cpu(recv: ast.expr) -> bool:
    return (isinstance(recv, ast.Call) and isinstance(recv.func, ast.Attribute)
            and recv.func.attr == "cpu")


def _device_arg(mod, call: ast.Call, names) -> bool:
    return any(mod.mentions_device(a, names) for a in call.args) or any(
        mod.mentions_device(kw.value, names) for kw in call.keywords)


@rule(
    "JL001",
    "host numpy/math call on a device value",
    "np./math. calls on a card tensor copy it to the host and compute there",
)
def check_host_calls(mod):
    for info in mod.fns.values():
        if not info.traced:
            continue
        for node in mod.own_nodes(info.node):
            if not isinstance(node, ast.Call):
                continue
            canon = mod.canonical(node.func)
            if canon is None or canon in _SYNC_NP:
                continue
            if canon.startswith(("numpy.", "math.")) and _device_arg(
                    mod, node, info.traced_names):
                yield mod.finding(
                    "JL001", node,
                    f"{canon} called on a device value inside device function "
                    f"'{info.qualname}'",
                    "use the torch equivalent so the op stays on the device",
                )


@rule(
    "JL003",
    "host sync on a device value",
    "float()/.item()/.cpu()/np.asarray()/torch.tensor(host, device=) wait for the card",
)
def check_host_syncs(mod):
    for info in mod.fns.values():
        if not info.traced:
            continue
        names = info.traced_names
        for node in mod.own_nodes(info.node):
            if not isinstance(node, ast.Call):
                continue
            # float(t) / int(t) / bool(t) on a device t
            if isinstance(node.func, ast.Name) and node.func.id in ("float", "int", "bool"):
                if node.func.id not in mod.aliases and _device_arg(mod, node, names):
                    yield mod.finding(
                        "JL003", node,
                        f"{node.func.id}() reads a device value back to the host inside "
                        f"device function '{info.qualname}'",
                        "keep the value on the device (a 0-d tensor) or read it once "
                        "after the work is queued",
                    )
                continue
            canon = mod.canonical(node.func)
            if canon in _SYNC_NP:
                if _device_arg(mod, node, names):
                    yield mod.finding(
                        "JL003", node,
                        f"{canon} copies a device value to the host inside device "
                        f"function '{info.qualname}'",
                        "operate on the tensor directly (torch.*)",
                    )
                continue
            if canon in _UPLOAD_CTORS:
                if any(kw.arg == "device" for kw in node.keywords) and not (
                        node.args and mod.mentions_device(node.args[0], names, False)):
                    yield mod.finding(
                        "JL003", node,
                        f"{canon}(host data, device=...) copies host data onto the "
                        f"device inside device function '{info.qualname}' (the copy "
                        "waits for the stream)",
                        "pass a Python scalar to the op, or build the tensor once "
                        "outside the call",
                    )
                continue
            # t.item() / t.tolist() / t.cpu() / t.numpy() on a device t (a
            # .cpu().numpy() chain is one read, reported at the .cpu())
            if (isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS
                    and mod.mentions_device(node.func.value, names)
                    and not _after_cpu(node.func.value)):
                yield mod.finding(
                    "JL003", node,
                    f".{node.func.attr}() reads a device value back to the host inside "
                    f"device function '{info.qualname}'",
                    "return the device tensor and read it after dispatch",
                )
