"""Config-ablation matrix: price each engine and protocol lever per tick.

Each lever is a fresh build of the flagship Handel with one switch
flipped ("pre_r5" flips both of the JAX package's r5 parity levers at
once), warmed with a real run_ms_batched pass for realistic channel
occupancy, then timed with telemetry.phases.scan_phase_seconds (the
warm-up pass discarded, mean and spread of the timed passes).  A lever's
delta is flagged untrustworthy when it lies inside twice the combined
spread of the two configs it compares.

The port's levers are the JAX package's less two that have no
counterpart here: `bitops_pallas` (the tensor's device picks the kernel
form; there is no switch) and `annotations_off` (the port has no
named-scope annotation); asking for either raises.  The port has only
the fused step, so `fuse_step` and `wheel_fused` build what `base` and
`wheel` build.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..protocols.handel import flagship_params

DEFAULT_WARM_MS = 120
WHEEL_LEVER_ROWS = 512  # engine.core.DEFAULT_WHEEL_ROWS

# the JAX package's levers that the port has no switch for
UNSUPPORTED_LEVERS = {
    "bitops_pallas": "the kernel form follows the tensor's device; there is no switch",
    "annotations_off": "the port carries no named-scope annotations",
}


def _lever_builders(node_ct: int, device) -> Dict[str, Callable]:
    """name -> () -> (net, state).  "base" is the flagship as the card
    runs it (D = 32, boundary view, flat store, no side-cars, the score
    cache on the card's default); every other entry flips one lever but
    "pre_r5", which flips both r5 parity levers at once."""
    from ..protocols.handel_batched import make_handel

    def p(channel_depth=None):
        params = flagship_params(node_ct)
        if channel_depth is not None:
            params.channel_depth = channel_depth
        return params

    def base():
        return make_handel(p(), device=device)

    def channel_depth_8():
        return make_handel(p(channel_depth=8), device=device)

    def boundary_view_off():
        return make_handel(p(), boundary_view=False, device=device)

    def pre_r5():
        return make_handel(p(channel_depth=8), boundary_view=False, device=device)

    def wheel():
        return make_handel(p(), wheel_rows=WHEEL_LEVER_ROWS, device=device)

    def score_cache_on():
        return make_handel(p(), score_cache=True, device=device)

    def score_cache_off():
        return make_handel(p(), score_cache=False, device=device)

    def telemetry_on():
        from ..telemetry import TelemetryConfig

        net, state = make_handel(p(), device=device)
        return net.with_telemetry(state, TelemetryConfig())

    def faults_on():
        net, state = make_handel(p(), device=device)
        return net.with_faults(state, plan=None)  # neutral schedule

    return {
        "base": base,
        "channel_depth_8": channel_depth_8,
        "boundary_view_off": boundary_view_off,
        "pre_r5": pre_r5,
        "wheel": wheel,
        "score_cache_on": score_cache_on,
        "score_cache_off": score_cache_off,
        "fuse_step": base,  # only the fused step exists
        "wheel_fused": wheel,
        "telemetry_on": telemetry_on,
        "faults_on": faults_on,
    }


LEVER_NOTES = {
    "base": "flagship as the card runs it: D=32, boundary view, flat, bare, "
    "score cache device-default (on for CUDA)",
    "channel_depth_8": "r4 channel depth (D=8 vs 32) — the displacement fix's price",
    "boundary_view_off": "pre-r5 same-tick selection (NOT parity-correct)",
    "pre_r5": "both r5 parity levers off — the r4 hot loop",
    "wheel": f"time-wheel store (wheel_rows={WHEEL_LEVER_ROWS}) vs flat",
    "score_cache_on": "carried candidate-score caches PINNED ON (base's "
    "default on the card: ~= base there)",
    "score_cache_off": "carried candidate-score caches PINNED OFF — full "
    "popcount recompute",
    "fuse_step": "the fused step: the port's only step, so = base",
    "wheel_fused": "the fused step on the wheel store = wheel; measured against `wheel`",
    "telemetry_on": "telemetry side-car armed",
    "faults_on": "fault side-car armed, neutral schedule",
}

# levers whose delta is measured against a config OTHER than base
LEVER_BASELINE: Dict[str, str] = {
    "wheel_fused": "wheel",
}

SMOKE_LEVERS = (
    "base",
    "channel_depth_8",
    "boundary_view_off",
    "pre_r5",
    "score_cache_on",
    "score_cache_off",
    "fuse_step",
)


def smoke_ablation_configs() -> List[str]:
    """The CI-tier subset: the levers the r4 -> r5 attribution needs."""
    return list(SMOKE_LEVERS)


def ablation_matrix(
    node_ct: int = 256,
    n_replicas: int = 4,
    scans: int = 25,
    repeats: int = 3,
    warm_ms: int = DEFAULT_WARM_MS,
    levers: Optional[List[str]] = None,
    tracer=None,
    device=None,
) -> dict:
    """Measure the full-step tick cost of each lever's config on `device`
    (None = CUDA).  Returns {"config", "backend", "configs": {name:
    {tick_us, std_us, min_us, note}}}."""
    from ..engine import replicate_state
    from ..engine.core import resolve_device
    from ..telemetry.phases import scan_phase_seconds

    dev = resolve_device(device)
    builders = _lever_builders(node_ct, dev)
    names = levers if levers is not None else list(builders)
    refused = sorted(set(names) & set(UNSUPPORTED_LEVERS))
    if refused:
        raise ValueError("ablation levers without a counterpart in the port: " + "; ".join(
            f"{n} ({UNSUPPORTED_LEVERS[n]})" for n in refused))
    unknown = sorted(set(names) - set(builders))
    if unknown:
        raise ValueError(f"unknown ablation levers: {unknown}")
    if "base" not in names:
        names = ["base"] + list(names)

    configs: Dict[str, dict] = {}
    for name in names:
        net, state = builders[name]()
        states = replicate_state(state, n_replicas)
        states = net.run_ms_batched(states, warm_ms)  # realistic occupancy
        t = scan_phase_seconds(
            states, {"full_step": net.step}, scans, tracer, repeats=repeats
        )["full_step"]
        configs[name] = {
            "tick_us": round(t["mean_s"] * 1e6, 2),
            "std_us": round(t["std_s"] * 1e6, 2),
            "min_us": round(t["min_s"] * 1e6, 2),
            "note": LEVER_NOTES.get(name, ""),
        }
    return {
        "config": {
            "node_count": node_ct,
            "n_replicas": n_replicas,
            "scans": scans,
            "repeats": repeats,
            "warm_ms": warm_ms,
        },
        "backend": dev.type,
        "configs": configs,
    }


def lever_report(matrix: dict) -> dict:
    """Rank levers by |per-tick delta vs base| and decompose the r4 -> r5
    regression into its two named levers + interaction residual.

    Sign convention: delta_us > 0 means the LEVER CONFIG is cheaper
    than its comparison config (base, or LEVER_BASELINE[name]) by that
    much per tick — i.e. the comparison config PAYS delta_us for what
    the lever removes."""
    configs = matrix["configs"]
    base = configs["base"]
    levers = []
    for name, c in configs.items():
        if name == "base":
            continue
        cmp_name = LEVER_BASELINE.get(name, "base")
        cmp_cfg = configs.get(cmp_name, base)
        if cmp_name not in configs:
            cmp_name = "base"
        delta = cmp_cfg["tick_us"] - c["tick_us"]
        spread = 2.0 * (cmp_cfg["std_us"] + c["std_us"])
        row = {
            "lever": name,
            "tick_us": c["tick_us"],
            "delta_us": round(delta, 2),
            "delta_pct_of_base": (
                round(delta / cmp_cfg["tick_us"] * 100, 1)
                if cmp_cfg["tick_us"]
                else None
            ),
            "trustworthy": abs(delta) > spread,
            "note": c.get("note", ""),
        }
        if cmp_name != "base":
            row["vs"] = cmp_name
        levers.append(row)
    levers.sort(key=lambda r: -abs(r["delta_us"]))

    report = {
        "base_tick_us": base["tick_us"],
        "base_std_us": base["std_us"],
        "ranked_levers": levers,
    }

    # r4 -> r5 attribution: base (r5) vs pre_r5 (r4 levers), decomposed
    if "pre_r5" in configs:
        total = base["tick_us"] - configs["pre_r5"]["tick_us"]
        parts = {}
        if "channel_depth_8" in configs:
            parts["channel_depth_32_us"] = round(
                base["tick_us"] - configs["channel_depth_8"]["tick_us"], 2
            )
        if "boundary_view_off" in configs:
            parts["boundary_view_us"] = round(
                base["tick_us"] - configs["boundary_view_off"]["tick_us"], 2
            )
        interaction = total - sum(parts.values())
        report["r4_to_r5_attribution"] = {
            "total_regression_us_per_tick": round(total, 2),
            **parts,
            "interaction_us": round(interaction, 2),
            "note": (
                "positive = the r5 parity config pays this much more per"
                " tick than the r4 config; levers measured one-at-a-time"
                " from base, interaction = total - sum(parts)"
            ),
        }

    if "annotations_off" in configs:
        off = configs["annotations_off"]["tick_us"]
        if off:
            report["annotation_overhead_pct"] = round(
                (base["tick_us"] - off) / off * 100, 2
            )
    return report


def format_lever_report(report: dict) -> str:
    """Human rendering of lever_report()."""
    lines = [
        f"base full-step: {report['base_tick_us']:.1f} us/tick"
        f" (+-{report['base_std_us']:.1f})",
        f"{'lever':<20} {'us/tick':>9} {'delta':>8} {'%base':>6}  trust note",
    ]
    for r in report["ranked_levers"]:
        trust = "ok " if r["trustworthy"] else "~? "
        vs = f" [vs {r['vs']}]" if r.get("vs") else ""
        lines.append(
            f"{r['lever']:<20} {r['tick_us']:>9.1f} {r['delta_us']:>8.1f}"
            f" {r['delta_pct_of_base'] or 0:>5.1f}%  {trust} {r['note']}{vs}"
        )
    attr = report.get("r4_to_r5_attribution")
    if attr:
        lines.append("r4->r5 regression attribution (us/tick):")
        for k in (
            "total_regression_us_per_tick",
            "channel_depth_32_us",
            "boundary_view_us",
            "interaction_us",
        ):
            if k in attr:
                lines.append(f"  {k:<28} {attr[k]:>8.2f}")
    if "annotation_overhead_pct" in report:
        lines.append(
            f"annotation overhead: {report['annotation_overhead_pct']:+.2f}%"
        )
    return "\n".join(lines)
