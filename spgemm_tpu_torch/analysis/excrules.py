"""EXC: exception contracts on failover paths.

The serving layer's correctness depends on two handler disciplines that
used to live only in comments:

  * A broad `except Exception` is load-bearing on the failover paths
    (chain_product's device-loss retry, the executor loop, the OOC
    workers): it must carry the repo's `# noqa: BLE001 -- <reason>`
    justification ON ITS LINE, where the reason is the reviewable citation
    of which failover contract licenses the broad catch.  A naked broad
    catch is a finding.
  * A bare `except:` or `except BaseException` would also swallow
    BaseException-derived CONTROL signals -- serve.queue.JobAbandoned is a
    BaseException precisely so a watchdog abort pierces the failover
    catch to the executor loop (PR 5).  Such a handler must therefore
    provably re-raise: its body must END in a `raise` statement.  A
    conditional or absent re-raise is a finding.

Escape hatch: `# spgemm-lint: exc-ok(<reason>)` on the handler's line or
the line above, for the rare handler whose swallow is itself the contract
(audited like every escape -- a stale one is a SUP finding).
"""

from __future__ import annotations

import ast

from spgemm_tpu_torch.analysis.core import Finding, LintUnit

BLE_MARKER = "noqa: BLE001"


def _handler_names(type_node: ast.expr | None) -> set[str]:
    """Last-component names of the caught types; {"<bare>"} for a bare
    except."""
    if type_node is None:
        return {"<bare>"}
    nodes = type_node.elts if isinstance(type_node, ast.Tuple) else [type_node]
    names = set()
    for n in nodes:
        if isinstance(n, ast.Name):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
    return names


def _ends_in_raise(body: list[ast.stmt]) -> bool:
    return bool(body) and isinstance(body[-1], ast.Raise)


def _ble_reason_on(comment: str) -> bool:
    """True iff the comment carries `# noqa: BLE001 -- <non-empty reason>`
    (the comment comes from core.comment_map, so a quoted marker in a
    string on the handler line never counts)."""
    pos = comment.find(BLE_MARKER)
    if pos < 0:
        return False
    rest = comment[pos + len(BLE_MARKER):].strip()
    return rest.startswith("--") and bool(rest[2:].strip())


def check_exc(unit: LintUnit, escapes: set[int]) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(unit.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.lineno in escapes or node.lineno - 1 in escapes:
            continue
        names = _handler_names(node.type)
        if "<bare>" in names or "BaseException" in names:
            if not _ends_in_raise(node.body):
                spelled = "bare `except:`" if "<bare>" in names \
                    else "`except BaseException`"
                findings.append(Finding(
                    unit.file, node.lineno, "EXC",
                    f"{spelled} must provably re-raise (end the handler "
                    "with `raise`): it would otherwise swallow "
                    "BaseException-derived control signals -- "
                    "serve.queue.JobAbandoned is a BaseException precisely "
                    "so a watchdog abort pierces broad failover catches; "
                    "escape with `# spgemm-lint: exc-ok(<reason>)` only if "
                    "the swallow IS the contract"))
        elif "Exception" in names:
            # the handler CLAUSE can wrap (a tuple of caught types split
            # across lines): the justification counts on any of its lines
            clause_end = getattr(node.type, "end_lineno", None) \
                or node.lineno
            justified = any(
                _ble_reason_on(unit.comments.get(line, ""))
                for line in range(node.lineno, clause_end + 1))
            if not justified:
                findings.append(Finding(
                    unit.file, node.lineno, "EXC",
                    "broad `except Exception` without justification: add "
                    "`# noqa: BLE001 -- <reason>` on the handler line "
                    "naming the failover contract that licenses the broad "
                    "catch (or narrow the handler); escape with "
                    "exc-ok(<reason>) for non-failover code"))
    return findings
