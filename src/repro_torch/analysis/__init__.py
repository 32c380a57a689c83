"""repro_torch.analysis — the port's static analysis (stdlib ``ast`` only).

Counterpart of ``repro.analysis``, with the same rules, IDs, suppression
contract and CLI, keyed on the port's PyTorch idioms.

Design note
===========

The paper's claim is reduced precision with precise control over its
accuracy: Q-format choices where raw accumulation cannot overflow and
truncation error is bounded.  The port does its raw arithmetic its own way —
int32 tensors holding uint32 bits, widened to int64 (``widen_u32``),
computed, and wrapped back (``wrap_u32``) — so the reference's rules, which
know ``segment_sum`` and ``.astype``, cannot see it.  This package turns the
port's conventions into checkable rules over the stdlib ``ast`` (the
analyzer imports neither torch nor JAX and runs anywhere CI does).

Architecture — three small layers:

``core``
    ``Finding`` / ``Rule`` + registry, ``FileContext`` (one parsed file with
    its ``tokenize``-derived comment tables), the file walk, and the repo-derived
    ``AnalysisConfig`` (the widest registered ``QFormat`` is parsed out of
    the port's ``core/fixed_point.py``, so width rules track the actual
    precision ladder).

rule packs
    ``fixedpoint`` (FXP001 raw-accumulation-width over ``index_add_`` /
    ``scatter_add_`` / ``sum``, FXP002 shift-discards-bits, FXP003
    raw-domain-discipline), ``torch_hygiene`` (TOR101 implicit-sync, TOR102
    host-numpy-on-tensor, TOR103 tensor-control-flow — scoped to
    ``# repro: hot-path``-marked functions so telemetry/debug code stays
    exempt), ``async_serving`` (ASY301 blocking-call-in-async, ASY302
    blocking-future-result, ASY303 sync-service-call-in-async, ASY304
    future-leak — scoped to ``async def`` bodies).

``baseline`` + ``cli``
    ``python -m repro_torch.analysis`` with text/JSON output, ``--check``
    gating, and a committed (ideally absent) findings baseline.

Philosophy: rules are *taint passes with teeth* — deliberately simple
forward passes over one function at a time, tuned to the port's idioms
(``_raw`` naming, ``fmt.mul``, ``widen_u32``, ``service.poll``).
False-positive control is structural (only fire on derived facts, e.g.
FXP002 needs an actually inferred width) plus explicit: every silenced
finding needs an inline ``# repro: allow[RULE-ID] reason`` — a bare
``allow`` suppresses nothing and is itself reported (SUP000).  The baseline
can only shrink: ``--check`` fails on stale entries too.
"""
from .core import (AnalysisConfig, AnalysisResult, FileContext, Finding,
                   Rule, all_rules, analyze_paths, get_rule, load_config,
                   register_rule)

__all__ = [
    "AnalysisConfig", "AnalysisResult", "FileContext", "Finding", "Rule",
    "all_rules", "analyze_paths", "get_rule", "load_config", "register_rule",
]
