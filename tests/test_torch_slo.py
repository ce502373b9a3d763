"""The port's SLO engine (obs/slo.py) against the JAX package's.

On the same synthetic series, fed at the same fake clock times, both
engines give the same per-spec rows, the same alert sequence (fired and
resolved, page and warn, as flight-recorder events) and the same
status(); direct violations count and export the same.  The port's
default_serve_specs reads no file: it equals the JAX package's
default_serve_specs(floor=0), and with a floor it equals the JAX
package's with that floor.
"""

import dataclasses

import pytest

from wittgenstein_tpu.obs import recorder as jrec
from wittgenstein_tpu.obs import slo as jslo
from wittgenstein_tpu.obs import timeseries as jts
from wittgenstein_tpu.telemetry.export import PromText as JProm
from wittgenstein_tpu_torch.obs import recorder as trec
from wittgenstein_tpu_torch.obs import slo as tslo
from wittgenstein_tpu_torch.obs import timeseries as tts
from wittgenstein_tpu_torch.telemetry.export import PromText as TProm


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _events(rec):
    return [{k: v for k, v in e.items() if k not in ("ts", "seq")} for e in rec.events()]


def _drive(ts_mod, slo_mod, rec_mod):
    """Queue waits and errors over two hours of fake time: a burst of
    slow waits (page), its fast window passing (warn), the slow window
    passing (resolved); one error (page on the zero objective)."""
    clock = _Clock()
    store = ts_mod.TimeSeriesStore(clock=clock)
    rec = rec_mod.FlightRecorder()
    specs = slo_mod.default_serve_specs(floor=0, fast_window_s=60.0, slow_window_s=600.0)
    engine = slo_mod.SLOEngine(store, specs, recorder=rec)
    rows = [engine.evaluate()]
    for i in range(20):
        clock.t += 1.0
        store.observe("serve.queue_wait_s", 5.0 if i < 15 else 45.0,
                      ctx={"run_id": f"run-{i}", "job_id": f"job-{i}"})
    rows.append(engine.evaluate())
    clock.t += 120.0
    rows.append(engine.evaluate())
    store.inc("serve.errors_total", ctx={"run_id": "run-bad"})
    rows.append(engine.evaluate())
    clock.t += 1200.0
    for i in range(5):
        store.observe("serve.queue_wait_s", 1.0)
    rows.append(engine.evaluate())
    engine.fire_violation("store-invariant", protocol="Handel", replica=3)
    status = engine.status()
    p = (TProm if slo_mod is tslo else JProm)()
    engine.add_prometheus(p)
    return rows, _events(rec), status, engine.alert_counts(), p.render()


def test_alert_sequence_and_status_equal_jax():
    want = _drive(jts, jslo, jrec)
    got = _drive(tts, tslo, trec)
    assert got == want
    kinds = [e["kind"] for e in got[1]]
    assert "slo-alert" in kinds and "slo-resolved" in kinds
    assert "invariant-violation" in kinds
    assert {e.get("severity") for e in got[1] if e["kind"] == "slo-alert"} >= {"page", "warn"}


def _fields(specs):
    return [dataclasses.asdict(s) for s in specs]


def test_default_specs_read_no_file():
    assert _fields(tslo.default_serve_specs()) == _fields(jslo.default_serve_specs(floor=0))
    got = _fields(tslo.default_serve_specs(floor=0.25))
    want = _fields(jslo.default_serve_specs(floor=0.25))
    # the floor's description names where the floor comes from
    assert [{**f, "description": ""} for f in got] == [{**f, "description": ""} for f in want]
    assert got[-1]["name"] == "sims-per-sec-floor" and got[-1]["objective"] == 0.25
    assert tslo.REGISTERED_SLOS == jslo.REGISTERED_SLOS


@pytest.mark.parametrize("kw", [
    dict(name="nope", metric="m", objective=1.0),
    dict(name="ttfr-p95", metric="m", objective=1.0, reduce="max"),
    dict(name="ttfr-p95", metric="m", objective=1.0, direction="eq"),
    dict(name="ttfr-p95", metric="m", objective=1.0, fast_window_s=10.0, slow_window_s=5.0),
])
def test_spec_validation_equals_jax(kw):
    with pytest.raises(ValueError) as want:
        jslo.SLOSpec(**kw)
    with pytest.raises(ValueError) as got:
        tslo.SLOSpec(**kw)
    assert str(got.value).split(" — ")[0] == str(want.value).split(" — ")[0]
