"""JL006: device work at module import time.

A module-level ``torch.zeros(..., device="cuda")`` or ``torch.cuda.*``
call initialises the CUDA context as a side effect of ``import`` — before
the application chooses its device, in every process that imports the
package (the tests import every module on machines without a card), and
in every worker process before it is bound to its own card. Module scope
may define functions and constants, but must not touch the device.
"""

from __future__ import annotations

import ast

from . import rule


def _device_kw(call: ast.Call) -> bool:
    """A ``device=`` argument that is not the literal CPU."""
    for kw in call.keywords:
        if kw.arg == "device":
            v = kw.value
            return not (isinstance(v, ast.Constant) and v.value == "cpu")
    return False


@rule(
    "JL006",
    "device work at module import time",
    "module-level torch.cuda calls and device tensors initialise CUDA on import",
)
def check_import_time(mod):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or mod.enclosing_fn(node) is not None:
            continue  # inside a function: runs when called, not on import
        canon = mod.canonical(node.func)
        if canon is not None and canon.startswith("torch.cuda."):
            yield mod.finding(
                "JL006", node,
                f"module-level {canon} call touches CUDA at import time",
                "defer it until first use",
            )
        elif (canon is not None and canon.startswith("torch.") and _device_kw(node)) or (
                isinstance(node.func, ast.Attribute) and node.func.attr == "cuda"):
            yield mod.finding(
                "JL006", node,
                "module-level tensor placed on a device at import time",
                "make it inside a function or cache it lazily",
            )
