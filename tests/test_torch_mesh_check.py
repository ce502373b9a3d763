"""The port's mesh audit (analysis/mesh_check.py, SL1001) against the JAX
package's: every registry entry is clean in both, and each of the
audit's three defects, seeded the same way into both packages, gives
SL1001 with the same message — a protocol leaf named like an engine
store field, a stale `_MESSAGE_STORE_FIELDS` exclusion, and a
classification whose stacked and single views disagree.  The command
line runs the audit as its `mesh` pass.
"""

import dataclasses

import pytest
import torch

from wittgenstein_tpu.analysis import mesh_check as jmc
from wittgenstein_tpu.core import registries as jregs
from wittgenstein_tpu.parallel import mesh2d as jm
from wittgenstein_tpu.parallel import node_shard as jns
from wittgenstein_tpu_torch.analysis import cli
from wittgenstein_tpu_torch.analysis import mesh_check as tmc
from wittgenstein_tpu_torch.core import registries as tregs
from wittgenstein_tpu_torch.parallel import mesh2d as tm
from wittgenstein_tpu_torch.parallel import node_shard as tns

NAMES = [e.name for e in tregs.registry_batched_protocols.entries() if e.contract_checks]
SUBSET = ("handel", "pingpong", "p2pflood_faults")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _messages(findings):
    assert all(f.rule == "SL1001" for f in findings)
    return sorted(f.message for f in findings)


def test_registry_names_match():
    assert NAMES == [e.name for e in jregs.registry_batched_protocols.entries()
                     if e.contract_checks]


@pytest.mark.parametrize("name", NAMES)
def test_every_entry_clean_in_both(name):
    seen_t, seen_j = set(), set()
    assert tmc.check_entry_mesh(tregs.registry_batched_protocols.get(name), device="cpu",
                                _stale_seen=seen_t) == []
    assert jmc.check_entry_mesh(jregs.registry_batched_protocols.get(name),
                                _stale_seen=seen_j) == []
    assert seen_t == seen_j


def _with_leaf(entry, key):
    """The entry with one more protocol leaf, a node column named `key`."""
    def factory(**kw):
        net, state = entry.factory(**kw)
        col = state.done_at
        return net, state._replace(proto={**state.proto, key: col})

    return dataclasses.replace(entry, factory=factory)


def test_seeded_store_name_collision():
    key = "shadow.msg_valid"
    got = tmc.check_entry_mesh(_with_leaf(tregs.registry_batched_protocols.get("pingpong"), key),
                               device="cpu")
    want = jmc.check_entry_mesh(_with_leaf(jregs.registry_batched_protocols.get("pingpong"),
                                           key))
    assert got and _messages(got) == _messages(want)
    assert all("collides" in f.message for f in got)


def _subset(monkeypatch, regs):
    reg = regs.registry_batched_protocols
    entries = [reg.get(n) for n in SUBSET]
    monkeypatch.setattr(reg, "entries", lambda: entries)


def test_seeded_stale_exclusion(monkeypatch):
    for regs in (tregs, jregs):
        _subset(monkeypatch, regs)
    assert tmc.check_mesh_layout(device="cpu") == [] and jmc.check_mesh_layout() == []
    for mod in (tns, jns):
        monkeypatch.setattr(mod, "_MESSAGE_STORE_FIELDS", mod._MESSAGE_STORE_FIELDS + (".bogus",))
    got, want = tmc.check_mesh_layout(device="cpu"), jmc.check_mesh_layout()
    assert len(got) == 1 and _messages(got) == _messages(want)
    assert "'.bogus'" in got[0].message and got[0].path.endswith("node_shard.py")


def test_seeded_stacked_single_disagreement(monkeypatch):
    def offsetless(classify):
        # a rule that forgets the stacked leading axis
        return lambda key, shape, n, stacked=True: classify(key, shape, n, stacked=False) \
            .replace("replicated", "replica-row" if stacked else "replicated")

    monkeypatch.setattr(tm, "classify_leaf", offsetless(tm.classify_leaf))
    monkeypatch.setattr(jm, "classify_leaf", offsetless(jm.classify_leaf))
    got = tmc.check_entry_mesh(tregs.registry_batched_protocols.get("handel"), device="cpu")
    want = jmc.check_entry_mesh(jregs.registry_batched_protocols.get("handel"))
    assert got and _messages(got) == _messages(want)
    assert all("single-state but" in f.message for f in got)


def test_cli_runs_the_mesh_pass():
    assert "mesh" in cli.PASSES
    stats = {}
    assert cli.run(".", device="cpu", protocols=["pingpong"], stats=stats) == []
    assert stats["mesh"]["entries"] == 1
