"""The port's search driver against the JAX package's, on P2PFlood.

A small ES campaign (the registry's P2PFlood, 400 ms, population 4, three
generations, seed 0) run by both packages gives the same config digest,
champion, history (less the wall seconds), points and frontier, field
for field.  Killed after one generation and resumed from its checkpoint
directory, the port's campaign reaches the same champion; a directory of
another config is refused.  A pin the port writes replays bitwise in the
JAX package's `verify_regression`, and one the JAX package writes
replays in the port's; an optimizer checkpoint written by either package
resumes a campaign in the other.  A generation evaluates through the
run cache, as the JAX package's does: a 2-generation campaign creates
one program and hits it once, in both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wittgenstein_tpu.parallel import replica_shard as jrc
from wittgenstein_tpu.scenarios import regressions as jreg
from wittgenstein_tpu.search import SearchConfig as JConfig
from wittgenstein_tpu.search import SearchDriver as JDriver
from wittgenstein_tpu_torch.obs.recorder import FlightRecorder
from wittgenstein_tpu_torch.parallel import replica_shard as trc
from wittgenstein_tpu_torch.scenarios import regressions as treg
from wittgenstein_tpu_torch.search import SearchConfig as TConfig
from wittgenstein_tpu_torch.search import SearchDriver as TDriver

SMALL = dict(protocol="p2pflood", sim_ms=400, generations=3, population=4, seed=0,
             optimizer="es", label="p2pflood-es-small")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _inference_mode():
    """The port's runs without autograd bookkeeping, as on the card."""
    with torch.inference_mode():
        yield


def _history(report):
    return [{k: v for k, v in row.items() if k != "eval_s"} for row in report["history"]]


@pytest.fixture(scope="module")
def jax_driver():
    driver = JDriver(JConfig(**SMALL))
    driver.run()
    return driver


@pytest.fixture(scope="module")
def jax_report(jax_driver):
    return jax_driver.report()


def _tdriver(**kw):
    return TDriver(TConfig(**{**SMALL, **kw}), recorder=FlightRecorder(), device="cpu")


def test_config_fields_and_digest():
    assert [f.name for f in dataclasses.fields(TConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]
    for kw in ({}, {"objective": "unavailability"}, {"seed": 7, "population": 6}):
        assert TConfig(**{**SMALL, **kw}).digest() == JConfig(**{**SMALL, **kw}).digest()
    assert TConfig(**SMALL, checkpoint_dir="/x").digest() == TConfig(**SMALL).digest()


def test_campaign_equals_jax(jax_driver, jax_report):
    rec = FlightRecorder()
    driver = TDriver(TConfig(**SMALL), recorder=rec, device="cpu")
    report = driver.run()
    assert report["config_digest"] == jax_report["config_digest"]
    assert report["champion"] == jax_report["champion"]
    assert _history(report) == _history(jax_report)
    assert report["frontier"] == jax_report["frontier"]
    assert driver.points == jax_driver.points
    assert report["config"] == jax_report["config"]
    assert driver.opt.state_meta() == jax_driver.opt.state_meta()
    for k, v in jax_driver.opt.state_arrays().items():
        assert np.array_equal(driver.opt.state_arrays()[k], v), k
    kinds = [e["kind"] for e in rec.events()]
    assert kinds == ["search-generation"] * 3 + ["search-complete"]


def test_generations_share_one_program():
    keys = ("hits", "misses", "compiles")
    deltas = []
    for info, driver in ((jrc.run_cache_info, lambda: JDriver(JConfig(**{**SMALL, "generations": 2}))),
                         (trc.run_cache_info, lambda: _tdriver(generations=2))):
        before = info()
        driver().run()
        deltas.append({k: info()[k] - before[k] for k in keys})
    assert deltas[1] == deltas[0] == {"hits": 1, "misses": 1, "compiles": 1}


def test_kill_and_resume_bitwise(tmp_path, jax_report):
    ck = str(tmp_path / "ck")
    first = _tdriver(checkpoint_dir=ck)
    first.run_generation()
    del first  # killed after generation 0
    rec = FlightRecorder()
    resumed = TDriver(TConfig(**SMALL, checkpoint_dir=ck), recorder=rec, device="cpu")
    assert resumed.generation == 1
    assert [e["kind"] for e in rec.events()] == ["search-resume"]
    report = resumed.run()
    assert report["champion"] == jax_report["champion"]
    assert _history(report) == _history(jax_report)
    assert report["frontier"] == jax_report["frontier"]
    with pytest.raises(ValueError, match="different search config"):
        _tdriver(checkpoint_dir=ck, seed=1)


def test_optimizer_checkpoint_crosses_packages(tmp_path, jax_report):
    """Generation 0 checkpointed by the JAX package resumes in the port,
    and the port's resumes in the JAX package: the same champion."""
    ck = str(tmp_path / "j2t")
    JDriver(JConfig(**SMALL, checkpoint_dir=ck)).run_generation()
    report = _tdriver(checkpoint_dir=ck).run()
    assert report["champion"] == jax_report["champion"]
    ck = str(tmp_path / "t2j")
    _tdriver(checkpoint_dir=ck).run_generation()
    jdrv = JDriver(JConfig(**SMALL, checkpoint_dir=ck))
    assert jdrv.generation == 1
    assert jdrv.run()["champion"] == jax_report["champion"]


def test_pins_replay_across_packages(tmp_path):
    driver = _tdriver(generations=1)
    driver.run()
    port_pin = tmp_path / "port.json"
    doc = driver.pin_champion(str(port_pin), with_baseline=False)
    out = jreg.verify_regression(str(port_pin), check_baseline=False)
    assert out["objective_value"] == doc["objective_value"]
    assert out["plan_digest"] == doc["plan_digest"]
    jdriver = JDriver(JConfig(**{**SMALL, "generations": 1}))
    jdriver.run()
    jax_pin = tmp_path / "jax.json"
    jdoc = jdriver.pin_champion(str(jax_pin), with_baseline=False)
    assert jdoc["genome"] == doc["genome"] and jdoc["plan_digest"] == doc["plan_digest"]
    got = treg.verify_regression(str(jax_pin), check_baseline=False, device="cpu")
    assert got["objective_value"] == jdoc["objective_value"]
    assert got["record"] == out["record"]
