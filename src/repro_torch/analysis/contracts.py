"""Program-contract registry (counterpart of ``repro.analysis.contracts``).

A :class:`Contract` names one structural claim about one entry point of
the port and the rules that check it.  The records live beside the hot
paths they describe: ``streaming/driver.py``, ``streaming/hierarchy.py``
and ``serve/engine.py`` call :func:`register` at import with a lazy
``run`` builder, so a contract costs nothing until it is checked.

``run(device)`` returns ``{variant label: thunk}``; each thunk runs once
under :func:`repro_torch.analysis.op_lint.record` (the reference traces a
jaxpr; the port runs the entry point at a tiny size, or on the card at the
engine's widths), and every rule checks every variant's record.
``runtime``, if set, takes the ``{label: Record}`` of the run and returns
extra :class:`RuleResult` rows for claims that read what the run returned
(the engine's pull ledger, the bill against the cost model).
``cuda_rules`` are added on the card (the host syncs by call site).  A run
that raises is reported as a failed ``run`` row, never raised.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Mapping, Sequence

import torch

from repro_torch.analysis import op_lint

__all__ = ["Contract", "RuleResult", "register", "registry", "get_contract",
           "check_contract", "check_all", "load_entry_points",
           "ENTRY_POINT_MODULES"]

# importing these populates the registry (records live with the hot paths)
ENTRY_POINT_MODULES = (
    "repro_torch.streaming.driver",
    "repro_torch.streaming.hierarchy",
    "repro_torch.serve.engine",
)


@dataclasses.dataclass(frozen=True)
class RuleResult:
    """One rule checked against one variant of one contract."""

    contract: str
    rule: str
    ok: bool
    detail: str

    def line(self) -> str:
        flag = "PASS" if self.ok else "FAIL"
        return f"[{flag}] {self.contract:<24s} {self.rule:<40s} {self.detail}"


@dataclasses.dataclass(frozen=True)
class Contract:
    """One structural claim about one entry point."""

    id: str
    where: str                   # dotted path of the entry point
    claim: str                   # the one-line claim
    run: Callable[[torch.device], Mapping[str, Callable]]
    rules: tuple = ()
    runtime: Callable[[dict], Sequence[RuleResult]] | None = None
    cuda_rules: tuple = ()


_REGISTRY: dict[str, Contract] = {}


def register(contract: Contract) -> Contract:
    """Add (or replace, for idempotent re-imports) a contract by id."""
    _REGISTRY[contract.id] = contract
    return contract


def registry() -> dict[str, Contract]:
    return dict(_REGISTRY)


def get_contract(contract_id: str) -> Contract:
    if contract_id not in _REGISTRY:
        raise KeyError(
            f"no contract {contract_id!r}; registered: {sorted(_REGISTRY)} "
            f"(did you call load_entry_points()?)")
    return _REGISTRY[contract_id]


def load_entry_points() -> dict[str, Contract]:
    """Import every module that declares contracts; return the registry."""
    for mod in ENTRY_POINT_MODULES:
        importlib.import_module(mod)
    return registry()


def _raised(e: BaseException) -> str:
    return f"raised {type(e).__name__}: {e}"


def check_contract(contract: Contract,
                   device: str | torch.device = "cpu") -> list[RuleResult]:
    """Run one contract's variants on ``device`` under the recorder, check
    every rule on each, then the runtime checks.  A run that raises is a
    failed rule (the entry point moved under the contract)."""
    dev = torch.device(device)
    cid = contract.id
    try:
        variants = contract.run(dev)
    except Exception as e:  # noqa: BLE001 - a broken builder is a finding
        return [RuleResult(cid, "run", False, _raised(e))]
    rules = contract.rules + (contract.cuda_rules if dev.type == "cuda"
                              else ())
    results: list[RuleResult] = []
    records: dict[str, op_lint.Record] = {}
    for label, thunk in variants.items():
        try:
            rec = op_lint.record(thunk, label=label, device=dev,
                                 syncs=bool(contract.cuda_rules)
                                 and dev.type == "cuda")
        except Exception as e:  # noqa: BLE001 - a broken run is a finding
            results.append(RuleResult(cid, f"run[{label}]", False,
                                      _raised(e)))
            continue
        records[label] = rec
        for rule in rules:
            try:
                rep = rule.check(rec)
            except Exception as e:  # noqa: BLE001 - a rule that cannot read
                results.append(RuleResult(     # its record fails
                    cid, f"{rule.name}[{label}]", False, _raised(e)))
                continue
            results.append(RuleResult(cid, f"{rep.rule}[{label}]", rep.ok,
                                      rep.detail))
    if contract.runtime is not None and records:
        try:
            results.extend(contract.runtime(records))
        except Exception as e:  # noqa: BLE001
            results.append(RuleResult(cid, "runtime", False, _raised(e)))
    return results


def check_all(only: str | None = None,
              device: str | torch.device = "cpu") -> list[RuleResult]:
    """Check every registered contract (an id-substring filter optional)."""
    load_entry_points()
    results: list[RuleResult] = []
    for cid in sorted(_REGISTRY):
        if only and only not in cid:
            continue
        results.extend(check_contract(_REGISTRY[cid], device))
    return results
