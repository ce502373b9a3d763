"""Contract checks on concrete steps (SL401-SL404, SL406, SL407, SL701,
SL901, SL1201).

Every protocol registered in `core.registries.registry_batched_protocols`
is built at its analysis scale on the given device, and its hooks run
concretely: the JAX package traces them abstractly (`jax.eval_shape`,
`jax.make_jaxpr`), but the port's step reads the device on every tick
(clock groups, masked-row skipping), so each abstract check has a
concrete counterpart here.  A state's fingerprint is (path, shape,
dtype) of its real leaves, and a hook passes a leaf through when the
output leaf is the same tensor object as its input and the tensor's
version counter has not moved (an in-place write moves it; identity
alone would miss one).

Rules:

SL401  step() must preserve the SimState tree: the same fields, proto
       keys and side-car types, and every leaf keeps its shape and dtype.
SL402  deliver() must not write engine-owned fields: on the delivery
       view, every engine-owned leaf of deliver's output must be a
       passthrough of its input, unless the field is declared in
       DELIVER_MAY_TOUCH.  Checked on the initial state and after the
       concrete steps below.
SL403  telemetry must be bit-neutral: with_telemetry() must leave every
       non-tele leaf's shape and dtype unchanged AND one concrete step
       must produce bit-identical non-tele leaves.
SL404  program drift: step() output leaves must keep the input's shape
       and dtype (the run cache keys on that geometry, so drift means a
       new program every call), and two steps from one cloned state must
       give bitwise identical states (on CUDA this catches a
       nondeterministic scatter; the check does not switch on
       torch.use_deterministic_algorithms to hide one).
SL406  fault-off neutrality: a fault-enabled engine running the neutral
       FaultState must leave every non-fault leaf's shape and dtype
       unchanged AND one concrete step must be bit-identical.
SL407  fault-lane ownership: deliver() on a fault-enabled delivery view
       must pass every state.faults leaf through.
SL701  derived-cache consistency: a protocol declaring
       DERIVED_CACHE_LEAVES must keep them equal to recompute_caches()'s
       from-scratch values; the entry is stepped concretely for several
       ticks and every declared leaf is compared bitwise.
SL901  narrow-dtype overflow audit: the engine's message-lane plan must
       cover (N-1, n_msg_types-1), every NARROW_LEAVES declaration must
       match its live leaf's dtype with the sentinel slot kept free, and
       after concrete steps every non-sentinel value must stay inside
       [0, declared_max].
SL1201 jump-safety audit: TICK_INTERVAL=None promises every inter-arrival
       tick is empty, so tick_beat must pass every leaf through.  A hook
       here takes a host tick and may branch on it, so tick_beat runs at
       several ticks (0, on a beat, off a beat, late); BEAT_PERIOD must
       stay undeclared.

A protocol suppresses rules for itself in its SIMLINT_SUPPRESS tuple.
"""

from __future__ import annotations

import inspect
import os
from typing import Any, List, Optional, Tuple

import torch

from ..engine.core import SimState, map_state, resolve_device
from ..engine.protocol import ENGINE_OWNED_FIELDS
from .findings import Finding, Severity

_MAX_LEAF_REPORTS = 4  # per rule per protocol; the rest are summarized
STEPS = 8  # concrete steps of SL701 and SL901
LATE_TICK = 10_007  # SL1201's late probe tick


def _proto_location(protocol) -> Tuple[str, int]:
    """(source file, class def line) of a protocol instance's class —
    where contract findings anchor."""
    cls = type(protocol)
    try:
        path = inspect.getsourcefile(cls) or "<unknown>"
        _, line = inspect.getsourcelines(cls)
    except (OSError, TypeError):
        path, line = "<unknown>", 1
    return path, line


def _anchor(protocol, root: str) -> Tuple[str, int]:
    path, line = _proto_location(protocol)
    try:
        path = os.path.relpath(path, root)
    except ValueError:
        pass
    return path, line


def _batched(state: SimState) -> SimState:
    """`state` with a leading replica axis (a factory's single-replica
    state becomes a batch of one, its own seed kept)."""
    if state.time.dim() == 0:
        return map_state(lambda a: a.unsqueeze(0), state)
    return state


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _leaf_paths(state) -> List[Tuple[str, torch.Tensor]]:
    """[(path, leaf)] in the JAX package's flatten order and key strings:
    `.time`, `.proto['agg']` (sorted keys), `.tele.sent` (field order)."""
    out = []
    for f in SimState._fields:
        v = getattr(state, f)
        if isinstance(v, dict):
            out += [(f".{f}['{k}']", v[k]) for k in sorted(v)]
        elif hasattr(v, "_fields"):
            out += [(f".{f}.{k}", getattr(v, k)) for k in v._fields]
        elif isinstance(v, torch.Tensor):
            out.append((f".{f}", v))
    return out


def _structure(state) -> tuple:
    """The tree structure: each field's kind, keys or side-car type."""
    out = []
    for f in SimState._fields:
        v = getattr(state, f)
        if isinstance(v, dict):
            out.append((f, "dict", tuple(sorted(v))))
        elif hasattr(v, "_fields"):
            out.append((f, type(v).__name__, tuple(v._fields)))
        else:
            out.append((f, type(v).__name__))
    return tuple(out)


def _fingerprint(state) -> List[Tuple[str, tuple, str]]:
    return [(p, tuple(leaf.shape), _dtype_name(leaf.dtype)) for p, leaf in _leaf_paths(state)]


def _diff_fingerprints(fp_in, fp_out) -> List[str]:
    """Human-readable per-leaf diffs, path-keyed."""
    by_path = {p: rest for p, *rest in fp_in}
    msgs = []
    for p, *rest in fp_out:
        if p not in by_path:
            msgs.append(f"{p}: leaf appears only in output")
        elif by_path[p] != rest:
            (si, di), (so, do) = by_path[p], rest
            msgs.append(f"{p}: {si}/{di} -> {so}/{do}")
    out_paths = {p for p, *_ in fp_out}
    for p in by_path:
        if p not in out_paths:
            msgs.append(f"{p}: leaf disappears in output")
    return msgs


def _bits(a: torch.Tensor) -> torch.Tensor:
    if a.is_floating_point():
        return a.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()])
    return a


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality: shape, dtype and every bit."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _stamp(t: torch.Tensor):
    """What a passthrough test compares against: the version counter, or
    (for an inference tensor, which keeps none) a copy of the data."""
    return t.clone() if t.is_inference() else t._version


def _passthrough(t_in: torch.Tensor, stamp, t_out) -> bool:
    """The output leaf is the input tensor itself, unwritten."""
    if t_out is not t_in:
        return False
    if isinstance(stamp, torch.Tensor):
        return _same(t_in, stamp)
    return t_in._version == stamp


def _mk(rule, path, line, msg, suppress) -> Optional[Finding]:
    if rule in suppress:
        return None
    return Finding(rule=rule, path=path, line=line, message=msg, severity=Severity.ERROR)


def _clone(state: SimState) -> SimState:
    return map_state(torch.clone, state)


def _clock(state: SimState) -> int:
    """The batch's shared clock (its smallest, if they differ)."""
    return int(state.time.min())


class _Entry:
    """One built entry: the engine, its batched state, and the state after
    STEPS concrete steps, computed once and shared by the rules."""

    def __init__(self, name: str, net, state: SimState, path: str, line: int):
        self.name, self.net, self.state = name, net, _batched(state)
        self.path, self.line = path, line
        self.suppress = set(getattr(net.protocol, "SIMLINT_SUPPRESS", ()) or ())
        self._stepped = None

    def mk(self, rule: str, msg: str) -> List[Finding]:
        f = _mk(rule, self.path, self.line, f"[{self.name}] {msg}", self.suppress)
        return [f] if f else []

    def stepped(self) -> SimState:
        if self._stepped is None:
            s = self.state
            for _ in range(STEPS):
                s = self.net.step(s)
            self._stepped = s
        return self._stepped


def _check_structure(e: _Entry):
    """SL401: step preserves tree structure + leaf shape/dtype."""
    try:
        out = e.net.step(e.state)
    except Exception as exc:  # the step itself failing IS the finding
        return e.mk("SL401", f"step() failed: {type(exc).__name__}: {exc}"), None
    if _structure(e.state) != _structure(out):
        return e.mk("SL401", "step() changes the SimState tree structure "
                    f"(in={_structure(e.state)}, out={_structure(out)})"), out
    findings = []
    diffs = _diff_fingerprints(_fingerprint(e.state), _fingerprint(out))
    for d in diffs[:_MAX_LEAF_REPORTS]:
        findings += e.mk("SL401", f"step() changes leaf shape/dtype: {d}")
    if len(diffs) > _MAX_LEAF_REPORTS:
        findings += e.mk("SL401", f"... and {len(diffs) - _MAX_LEAF_REPORTS} more "
                         "leaf shape/dtype changes")
    return findings, out


def _deliver_touched(net, state: SimState, fields) -> Tuple[Optional[dict], Any]:
    """Run deliver on `state`'s delivery view at its clock; returns
    ({field: [paths of its leaves not passed through]}, None), or
    (None, message) when deliver fails or changes the tree structure."""
    t = _clock(state)
    vstate, _due, deliver, _rows, _supp = net.delivery_view(state, t)
    stamps = {}
    for f in fields:
        v = getattr(vstate, f)
        leaves = ([(f".{k}", getattr(v, k)) for k in v._fields] if hasattr(v, "_fields")
                  else [("", v)] if isinstance(v, torch.Tensor) else [])
        stamps[f] = [(p, leaf, _stamp(leaf)) for p, leaf in leaves]
    try:
        pstate, _em = net.protocol.deliver(net, vstate, deliver, t)
    except Exception as exc:
        return None, f"deliver() failed on the delivery view: {type(exc).__name__}: {exc}"
    if not isinstance(pstate, SimState) or _structure(pstate) != _structure(vstate):
        return None, "deliver() changes the SimState tree structure"
    touched = {}
    for f, leaves in stamps.items():
        v = getattr(pstate, f)
        outs = ([getattr(v, p[1:]) for p, _, _ in leaves] if hasattr(v, "_fields")
                else [v] * len(leaves))
        bad = [p for (p, leaf, st), o in zip(leaves, outs) if not _passthrough(leaf, st, o)]
        if bad:
            touched[f] = bad
    return touched, None


def _check_msg_ownership(e: _Entry):
    """SL402: deliver() leaves engine-owned leaves as passthroughs, at the
    initial state and after the concrete steps."""
    allowed = set(getattr(e.net.protocol, "DELIVER_MAY_TOUCH", ()) or ())
    fields = [f for f in ENGINE_OWNED_FIELDS if f not in allowed]
    seen = set()
    findings = []
    for tag, state in (("initial", e.state), ("stepped", None)):
        try:
            state = e.stepped() if state is None else state
        except Exception as exc:
            return findings + e.mk("SL402", f"concrete stepping for the ownership check "
                                   f"failed: {type(exc).__name__}: {exc}")
        touched, err = _deliver_touched(e.net, state, fields)
        if err is not None:
            return findings + e.mk("SL402", f"{err} ({tag} state)")
        for f, leaves in touched.items():
            if f in seen:
                continue
            seen.add(f)
            findings += e.mk("SL402", f"deliver() writes engine-owned field '{f}' "
                             f"({len(leaves)} leaf(s) are not input passthroughs, "
                             f"{tag} state); return emissions instead, or declare it "
                             "in DELIVER_MAY_TOUCH")
    return findings


def _neutral_step(e: _Entry, rule: str, what: str, field: str, arm, out_plain):
    """SL403/SL406: the armed engine's step leaves every leaf outside
    `field` with the plain step's shapes, dtypes and bits."""
    try:
        anet, astate = arm()
        out_armed = anet.step(astate)
    except Exception as exc:
        return e.mk(rule, f"{what} instrumentation failed: {type(exc).__name__}: {exc}")
    plain = out_plain._replace(**{field: ()})
    armed = out_armed._replace(**{field: ()})
    diffs = _diff_fingerprints(_fingerprint(plain), _fingerprint(armed))
    findings = []
    for d in diffs[:_MAX_LEAF_REPORTS]:
        findings += e.mk(rule, f"{what} changes a non-{field} leaf: {d}")
    if diffs:
        return findings
    for (p, a), (_, b) in zip(_leaf_paths(plain), _leaf_paths(armed)):
        if not _same(a, b):
            return e.mk(rule, f"{what} perturbs sim dynamics: leaf {p} differs bitwise "
                        "after one instrumented step")
    return []


def _check_telemetry_neutral(e: _Entry, out_plain):
    """SL403: instrumentation leaves non-tele leaves bit-identical."""
    from ..telemetry.state import TelemetryConfig

    return _neutral_step(e, "SL403", "telemetry", "tele",
                         lambda: e.net.with_telemetry(e.state, TelemetryConfig(snapshots=0)),
                         out_plain)


def _check_fault_neutral(e: _Entry, out_plain):
    """SL406: a fault-enabled engine on the neutral schedule leaves
    non-fault leaves bit-identical.  Entries already fault-enabled (the
    fault-lane registry entries) are skipped: their schedule is
    deliberately non-neutral and the base entry covers neutrality."""
    from ..faults.state import FaultConfig

    if getattr(e.net, "faults", None) is not None:
        return []
    return _neutral_step(e, "SL406", "neutral fault schedule", "faults",
                         lambda: e.net.with_faults(e.state, FaultConfig()), out_plain)


def _check_fault_deliver_ownership(e: _Entry):
    """SL407: deliver() leaves the fault lane alone, on a fault-enabled
    delivery view (on a plain entry state.faults has no leaves, so
    SL402's scan is vacuous there)."""
    from ..faults.state import FaultConfig

    net, state = e.net, e.state
    if getattr(net, "faults", None) is None:
        try:
            net, state = net.with_faults(state, FaultConfig())
        except Exception as exc:
            return e.mk("SL407", f"fault instrumentation failed: {type(exc).__name__}: {exc}")
    if "faults" in set(getattr(net.protocol, "DELIVER_MAY_TOUCH", ()) or ()):
        return []
    touched, err = _deliver_touched(net, state, ["faults"])
    if err is not None:
        return e.mk("SL407", f"{err} (fault-enabled view)")
    if touched:
        names = ", ".join(touched["faults"][:_MAX_LEAF_REPORTS])
        return e.mk("SL407", f"deliver() writes the fault lane (state.faults leaves not "
                    f"passed through: {names}); the engine owns the fault schedule and "
                    "its counters")
    return []


def _check_derived_cache(e: _Entry):
    """SL701: carried derived-cache leaves stay equal to their from-scratch
    recompute after concrete steps.  Clean when the protocol declares no
    DERIVED_CACHE_LEAVES."""
    proto_obj = e.net.protocol
    leaves = tuple(getattr(proto_obj, "DERIVED_CACHE_LEAVES", ()) or ())
    if not leaves:
        return []
    proto = e.state.proto
    if not isinstance(proto, dict):
        return e.mk("SL701", f"declares DERIVED_CACHE_LEAVES {leaves} but state.proto is "
                    "not a dict, so the leaves cannot exist")
    missing = [lf for lf in leaves if lf not in proto]
    if missing:
        return e.mk("SL701", f"DERIVED_CACHE_LEAVES {missing} not present in the initial "
                    "state.proto (proto_init must seed every declared cache leaf)")
    try:
        oracle = proto_obj.recompute_caches(e.state)
    except Exception as exc:
        return e.mk("SL701", f"recompute_caches() failed on the initial state: "
                    f"{type(exc).__name__}: {exc}")
    uncovered = [lf for lf in leaves if lf not in oracle]
    if uncovered:
        return e.mk("SL701", f"recompute_caches() does not cover declared leaves "
                    f"{uncovered}; every DERIVED_CACHE_LEAVES entry needs a from-scratch "
                    "oracle")
    try:
        stepped = e.stepped()
        fresh = proto_obj.recompute_caches(stepped)
    except Exception as exc:
        return e.mk("SL701", f"concrete stepping for the cache-consistency check failed: "
                    f"{type(exc).__name__}: {exc}")
    findings = []
    for lf in leaves:
        if lf not in stepped.proto or lf not in fresh:
            findings += e.mk("SL701", f"derived cache '{lf}' DISAPPEARED during stepping: "
                             "a kernel hook rebuilt state.proto without carrying the "
                             "declared cache leaf through")
        elif not _same(stepped.proto[lf], fresh[lf]):
            findings += e.mk("SL701", f"derived cache '{lf}' is STALE: after {STEPS} "
                             "concrete steps the carried leaf differs bitwise from "
                             "recompute_caches() — an update path (deliver/commit/"
                             "select) forgot to maintain it")
    return findings


def _check_narrow_overflow(e: _Entry):
    """SL901: narrow packed dtypes must have provable headroom: (a) the
    engine's message-lane plan against the config's bounds, (b) every
    declared NarrowLeaf statically against the live initial state, (c)
    the declaration dynamically after concrete steps."""
    from ..engine.density import TORCH_DTYPES

    net = e.net
    findings = []
    lanes = getattr(net, "lanes", None)
    if lanes is not None:
        bounds = (("idx", max(0, net.n_nodes - 1), "node index"),
                  ("mtype", max(0, net.protocol.n_msg_types() - 1), "message type"))
        for attr, bound, what in bounds:
            dt = getattr(lanes, attr)
            if not dt.is_floating_point and bound > torch.iinfo(dt).max:
                findings += e.mk("SL901", f"engine lane '{attr}' stores {what} values up to "
                                 f"{bound} in {_dtype_name(dt)} (max {torch.iinfo(dt).max}) "
                                 "— the lane plan was overridden past its bound")
    specs = tuple(getattr(net.protocol, "NARROW_LEAVES", ()) or ())
    if not specs:
        return findings
    proto = e.state.proto
    if not isinstance(proto, dict):
        return findings + e.mk("SL901", "declares NARROW_LEAVES but state.proto is not a "
                               "dict, so the leaves cannot exist")
    for spec in specs:
        want = TORCH_DTYPES[spec.dtype]
        headroom = torch.iinfo(want).max - (1 if spec.sentinel else 0)
        if int(spec.declared_max) > headroom:
            findings += e.mk("SL901", f"NarrowLeaf '{spec.name}' declares max "
                             f"{spec.declared_max} but {spec.dtype} holds only {headroom}"
                             f"{' (top value reserved for the sentinel)' if spec.sentinel else ''}")
        if spec.name not in proto:
            findings += e.mk("SL901", f"NarrowLeaf '{spec.name}' is declared but absent from "
                             "the initial state.proto (config-gated leaves are fine at "
                             "runtime, but the registry entry should exercise every "
                             "declaration)")
            continue
        live = proto[spec.name].dtype
        if live != want:
            findings += e.mk("SL901", f"NarrowLeaf '{spec.name}' declares {spec.dtype} but the "
                             f"live leaf is {_dtype_name(live)} — proto_init forgot "
                             "narrow_proto(), or the declaration is stale")
    if findings:
        return findings
    try:
        stepped = e.stepped()
    except Exception as exc:
        return e.mk("SL901", f"concrete stepping for the narrow-range check failed: "
                    f"{type(exc).__name__}: {exc}")
    for spec in specs:
        if spec.name not in stepped.proto:
            continue  # disappearance is SL401's finding
        arr = stepped.proto[spec.name]
        if spec.sentinel:
            arr = arr[arr != torch.iinfo(arr.dtype).max]
        if arr.numel():
            lo, hi = int(arr.min()), int(arr.max())
            if lo < 0 or hi > int(spec.declared_max):
                findings += e.mk("SL901", f"NarrowLeaf '{spec.name}' observed values in "
                                 f"[{lo}, {hi}] after {STEPS} concrete steps, outside its "
                                 f"declared [0, {spec.declared_max}] — the bound the dtype "
                                 "choice rests on is wrong")
    return findings


def _probe_ticks(proto) -> List[int]:
    """SL1201's ticks: 0, one on a beat, one off every beat, and a late
    one (with no beat structure, 1 and 2 stand for the beat pair)."""
    period, residues = proto.BEAT_PERIOD, proto.BEAT_RESIDUES
    on, off = 1, 2
    if period and residues:
        res = sorted(int(r) % period for r in residues)
        on = period + res[0]
        off = next((period + r for r in range(period) if r not in res), on)
    return sorted({0, on, off, LATE_TICK})


def _check_jump_safety(e: _Entry):
    """SL1201: TICK_INTERVAL=None is the jump-safety declaration — the
    next-arrival jumps skip inter-arrival ticks outright, so tick_beat
    must pass every leaf through at every probed tick.  Declaring
    BEAT_PERIOD alongside TICK_INTERVAL=None is the same contradiction
    stated twice and is flagged on its own."""
    proto = e.net.protocol
    if proto.TICK_INTERVAL is not None:
        return []
    findings = []
    if getattr(proto, "BEAT_PERIOD", None) is not None:
        findings += e.mk("SL1201", f"declares TICK_INTERVAL=None (jumpable) AND "
                         f"BEAT_PERIOD={proto.BEAT_PERIOD}: periodic beat work contradicts "
                         "the empty-tick declaration the jump paths rely on")
    state = e.state
    leaves = _leaf_paths(state)
    for t in _probe_ticks(proto):
        stamps = [_stamp(leaf) for _, leaf in leaves]
        try:
            out = proto.tick_beat(e.net, state, t)
        except Exception as exc:
            return findings + e.mk("SL1201", f"tick_beat failed at t={t} for the jump-safety "
                                   f"audit: {type(exc).__name__}: {exc}")
        if not isinstance(out, SimState) or _structure(out) != _structure(state):
            return findings + e.mk("SL1201", f"tick_beat changes the SimState tree structure "
                                   f"at t={t} on a TICK_INTERVAL=None protocol — the jump "
                                   "paths skip its per-tick effects entirely")
        touched = [p for (p, leaf), st, (_, o) in zip(leaves, stamps, _leaf_paths(out))
                   if not _passthrough(leaf, st, o)]
        if touched:
            names = ", ".join(touched[:_MAX_LEAF_REPORTS])
            more = ("" if len(touched) <= _MAX_LEAF_REPORTS
                    else f" (+{len(touched) - _MAX_LEAF_REPORTS} more)")
            return findings + e.mk(
                "SL1201", f"declares TICK_INTERVAL=None but tick_beat is not a no-op at "
                f"t={t}: {len(touched)} leaf(s) are not input passthroughs ({names}{more}).  "
                "The next-arrival jump skips empty-occupancy ticks wholesale, so this "
                "per-tick work would silently vanish on the jumped path; declare "
                "TICK_INTERVAL/BEAT_PERIOD instead")
    return findings


def _check_recompile(e: _Entry, out):
    """SL404: step output fingerprint == input fingerprint (one program
    for chained runs), and two steps from one cloned state are bitwise
    equal."""
    if out is None:
        return []
    findings = []
    diffs = _diff_fingerprints(_fingerprint(e.state), _fingerprint(out))
    for d in diffs[:_MAX_LEAF_REPORTS]:
        findings += e.mk("SL404", f"step() output drifts from its input (chained runs "
                         f"would need a new program every call): {d}")
    if diffs:
        return findings
    try:
        again = e.net.step(_clone(e.state))
    except Exception as exc:
        return e.mk("SL404", f"step() failed on a cloned state: {type(exc).__name__}: {exc}")
    for (p, a), (_, b) in zip(_leaf_paths(out), _leaf_paths(again)):
        if not _same(a, b):
            return e.mk("SL404", f"two steps from one state differ bitwise at leaf {p} "
                        "(a nondeterministic scatter, or host state carried between "
                        "calls?)")
    return findings


def run_checks(name: str, net, state, root: str = ".") -> List[Finding]:
    """Every rule of this module for one built (net, state); the state may
    be a single replica's or a batch."""
    path, line = _anchor(net.protocol, root)
    with torch.inference_mode(False), torch.no_grad():
        e = _Entry(name, net, state, path, line)
        findings, out = _check_structure(e)
        findings += _check_msg_ownership(e)
        if out is not None:
            findings += _check_telemetry_neutral(e, out)
            findings += _check_fault_neutral(e, out)
        findings += _check_fault_deliver_ownership(e)
        findings += _check_derived_cache(e)
        findings += _check_narrow_overflow(e)
        findings += _check_jump_safety(e)
        findings += _check_recompile(e, out)
    return findings


def build_entry(entry, device):
    """(net, state) of a registry entry built on `device`, outside
    inference mode, so every state tensor keeps a version counter."""
    with torch.inference_mode(False), torch.no_grad():
        return entry.factory(device=device)


def check_entry(entry, root: str = ".", device=None) -> List[Finding]:
    """Run SL401-SL404, SL406, SL407, SL701, SL901 and SL1201 for one
    registry entry on `device` (CUDA unless asked for the CPU); [] when
    clean or when the entry opts out of contract checks (standalone
    engines)."""
    dev = resolve_device(device)
    if not entry.contract_checks:
        return []
    net, state = build_entry(entry, dev)
    return run_checks(entry.name, net, state, root)


def check_all(root: str = ".", names=None, device=None) -> List[Finding]:
    """Contract-check every registered batched protocol (or the named
    subset) on `device` (CUDA unless asked for the CPU)."""
    from ..core.registries import registry_batched_protocols

    dev = resolve_device(device)
    findings: List[Finding] = []
    for entry in registry_batched_protocols.entries():
        if names and entry.name not in names:
            continue
        findings.extend(check_entry(entry, root=root, device=dev))
    return findings
