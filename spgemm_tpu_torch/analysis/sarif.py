"""SARIF 2.1.0 emitter: CI/editor-annotatable lint output.

`python -m spgemm_tpu_torch.analysis --sarif lint.sarif` (or `make lint-sarif`)
writes one run with the full rule-id registry as tool.driver.rules and one
result per finding -- the shape GitHub code scanning and SARIF-aware
editors consume.  The contract test (tests/test_lint.py) pins the schema
shape; stale suppressions travel as ordinary SUP results.

Escaped findings are NOT dropped: each suppressed finding is emitted as a
result carrying a SARIF `suppressions` object (`kind: "inSource"`, the
escape comment's reason as the `justification`), so code scanning can
audit every escape instead of watching findings silently vanish.  An
active finding carries an explicit empty `suppressions` array -- the
SARIF 2.1.0 convention that lets a consumer distinguish "not suppressed"
from "suppression state unknown"."""

from __future__ import annotations

import json

from spgemm_tpu_torch.analysis.core import RULES, Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"


def _result(f: Finding, suppressions: list[dict]) -> dict:
    return {
        "ruleId": f.rule,
        "level": "error",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.file},
                "region": {"startLine": f.line},
            },
        }],
        "suppressions": suppressions,
    }


def render(findings: list[Finding],
           suppressed: list[tuple[Finding, str]] = ()) -> dict:
    """The SARIF log object (plain dict, json.dump-ready).

    suppressed: (finding, justification) pairs for findings an in-source
    escape comment suppressed -- emitted as results with a populated
    `suppressions` array."""
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                # no informationUri: SARIF 2.1.0 requires an ABSOLUTE URI
                # there and this repo has no canonical hosted URL -- the
                # property is optional, and strict consumers (GitHub code
                # scanning) reject relative ones.  The human pointer is
                # ARCHITECTURE.md "Enforced invariants (spgemm-lint)".
                "name": "spgemm-lint",
                "rules": [{
                    "id": rule_id,
                    "shortDescription": {"text": doc},
                } for rule_id, doc in RULES.items()],
            }},
            "results": [_result(f, []) for f in findings] + [
                _result(f, [{"kind": "inSource",
                             "justification": reason}])
                for f, reason in suppressed],
        }],
    }


def write(path: str, findings: list[Finding],
          suppressed: list[tuple[Finding, str]] = ()) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(render(findings, suppressed), f, indent=2)
        f.write("\n")
