"""The port's p2pfl-check against the JAX package's, and its teeth on the
port's own sources.

On the shared fixtures (``tests/fixtures/analysis``, read only) the port's
``send-under-lock``, ``monotone-merge`` and ``wire-header-compat`` report
the same rule ids, files, lines, columns and messages as JAX's; the
port's ``no-host-gather``, rewritten for torch's host materialisations,
flags the same lines but ``jax.device_get`` (a JAX call a torch plane
cannot make). Then each bug shape re-introduced in memory into the port's
shipped modules (control and federation commands, the gRPC, memory and
protobuf codecs, the ICI plane) must flag; suppression, baseline, the CLI's
exit codes and ``--list-rules``; and the self-run over the port is green.
"""

from __future__ import annotations

from pathlib import Path

import pytest

import p2pfl_tpu_torch
from p2pfl_tpu.analysis import analyze as jax_analyze
from p2pfl_tpu.analysis.rules import (
    MonotoneMergeRule as JaxMerge,
    NoHostGatherRule as JaxHostGather,
    SendUnderLockRule as JaxSendUnderLock,
    WireHeaderCompatRule as JaxWire,
)
from p2pfl_tpu_torch.analysis import Finding, Severity, analyze, load_baseline, new_findings, write_baseline
from p2pfl_tpu_torch.analysis.__main__ import main as cli_main
from p2pfl_tpu_torch.analysis.findings import format_findings
from p2pfl_tpu_torch.analysis.rules import (
    ALL_RULES,
    MonotoneMergeRule,
    NoHostGatherRule,
    SendUnderLockRule,
    WireHeaderCompatRule,
)

FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
PKG = Path(p2pfl_tpu_torch.__file__).parent
FIXTURE_PATHS = sorted(p.name for p in FIXTURES.iterdir() if p.suffix == ".py" or p.is_dir())


def rules_of(findings):
    return sorted({f.rule for f in findings})


def _rows(findings, with_message: bool = True):
    return [(f.rule, f.path, f.line, f.col, f.message if with_message else None, f.context) for f in findings]


# ---- parity with JAX on the shared fixtures ----


@pytest.mark.parametrize("rules", [(SendUnderLockRule, JaxSendUnderLock), (MonotoneMergeRule, JaxMerge),
                                   (WireHeaderCompatRule, JaxWire)], ids=lambda r: r[0].id)
@pytest.mark.parametrize("fixture", FIXTURE_PATHS)
def test_fixture_findings_equal_jax(fixture, rules):
    ours, theirs = rules
    path = [str(FIXTURES / fixture)]
    assert _rows(analyze(path, [ours])) == _rows(jax_analyze(path, [theirs]))
    assert ours.id == theirs.id and ours.summary == theirs.summary


@pytest.mark.parametrize("fixture", FIXTURE_PATHS)
def test_fixture_host_gather_lines_equal_jax(fixture):
    path = [str(FIXTURES / fixture)]
    ours = analyze(path, [NoHostGatherRule])
    theirs = [f for f in jax_analyze(path, [JaxHostGather]) if not f.message.startswith("jax.device_get")]
    assert [(f.rule, f.path, f.line, f.col) for f in ours] == [(f.rule, f.path, f.line, f.col) for f in theirs]
    # the call each names leads the message in both
    assert [f.message.split(" ", 1)[0] for f in ours] == [f.message.split(" ", 1)[0] for f in theirs]


def test_fixture_findings_over_all_rules():
    """Every fixture directory at once: the bad ones flag, the good pass."""
    found = analyze([str(FIXTURES)], ALL_RULES)
    flagged = {Path(f.path).relative_to(FIXTURES).parts[0] for f in found}
    assert {"send_under_lock_bad.py", "monotone_merge_bad.py", "wire_bad", "ici_bad"} <= flagged
    assert not any(name.endswith("_good.py") or name.endswith("_good") for name in flagged)


# ---- per-rule teeth on the fixtures ----


def run_fixture(name, rule):
    return analyze([str(FIXTURES / name)], [rule])


def test_send_under_lock_teeth():
    bad = run_fixture("send_under_lock_bad.py", SendUnderLockRule)
    assert len(bad) == 2
    assert rules_of(bad) == ["send-under-lock"]
    assert "no lock may be held across a send" in bad[0].message
    assert run_fixture("send_under_lock_good.py", SendUnderLockRule) == []


def test_monotone_merge_teeth():
    bad = run_fixture("monotone_merge_bad.py", MonotoneMergeRule)
    assert len(bad) == 3
    assert rules_of(bad) == ["monotone-merge"]
    assert run_fixture("monotone_merge_good.py", MonotoneMergeRule) == []


def test_wire_header_compat_teeth():
    bad = run_fixture("wire_bad", WireHeaderCompatRule)
    msgs = "\n".join(f.message for f in bad)
    for part in ("serialized unconditionally", "read with []", "without copying 'version'",
                 "without copying 'xp'", "protobuf interop codec"):
        assert part in msgs
    assert run_fixture("wire_good", WireHeaderCompatRule) == []


def test_no_host_gather_teeth():
    bad = run_fixture("ici_bad", NoHostGatherRule)
    msgs = "\n".join(f.message for f in bad)
    for part in ("np.asarray", ".tobytes()", ".item()", "np.frombuffer"):
        assert part in msgs
    assert run_fixture("ici_good", NoHostGatherRule) == []


TORCH_HOST_PLANE = """
import numpy as np
import torch


def probe(leaf, bufs, dev):
    a = leaf.cpu()
    b = leaf.numpy()
    c = leaf.tolist()
    d = leaf.to("cpu")
    e = leaf.to(device="cpu")
    f = leaf.to(torch.device("cpu"))
    g = np.array(leaf)
    ok1 = leaf.to(dev)
    ok2 = leaf.to(torch.bfloat16)
    ok3 = torch.empty_like(leaf).copy_(leaf, non_blocking=True)
    ok4 = leaf.to("cuda:1")
    return a, b, c, d, e, f, g, ok1, ok2, ok3, ok4
"""


def test_no_host_gather_flags_torch_materialisations():
    found = analyze([], [NoHostGatherRule], sources={"parallel/ici_plane.py": TORCH_HOST_PLANE})
    assert [f.line for f in found] == list(range(7, 14))
    assert [f.message.split(" ", 1)[0] for f in found] == [
        ".cpu()", ".numpy()", ".tolist()", ".to('cpu')", ".to('cpu')", ".to('cpu')", "np.array(…)"]


def test_no_host_gather_is_scope_targeted():
    src = (FIXTURES / "ici_bad" / "ici_plane.py").read_text()
    assert analyze([], [NoHostGatherRule], sources={"weights.py": src}) == []
    assert analyze([], [NoHostGatherRule], sources={"learning/weights.py": TORCH_HOST_PLANE}) == []


def test_wire_codec_sets_are_per_directory():
    both = analyze([str(FIXTURES / "wire_good"), str(FIXTURES / "wire_bad")], [WireHeaderCompatRule])
    assert both and all("wire_bad" in f.path for f in both)
    alone = analyze([str(FIXTURES / "wire_bad")], [WireHeaderCompatRule])
    assert {f.fingerprint for f in both} == {f.fingerprint for f in alone}


# ---- teeth against the port's shipped modules ----


def _read(rel):
    return (PKG / rel).read_text()


def _mutate(rel, old, new):
    src = _read(rel)
    mutated = src.replace(old, new, 1)
    assert mutated != src, f"{rel}: the needle is gone; update the teeth to the new source"
    return src, mutated


def test_shipped_control_flags_when_merge_lock_removed():
    src, mutated = _mutate(
        "commands/control.py",
        "        with self._state.status_merge_lock:\n            self._state.nei_status.setdefault(source, -1)",
        "        self._state.nei_status.setdefault(source, -1)",
    )
    assert analyze([], [MonotoneMergeRule], sources={"commands/control.py": src}) == []
    found = analyze([], [MonotoneMergeRule], sources={"commands/control.py": mutated})
    assert any(f.rule == "monotone-merge" and "nei_status" in f.message for f in found)


def test_shipped_federation_command_flags_send_moved_under_lock():
    src, mutated = _mutate(
        "commands/federation.py",
        "        with st.status_merge_lock:\n            st.async_done_peers.add(source)\n",
        "        with st.status_merge_lock:\n"
        "            st.async_done_peers.add(source)\n"
        "            self._node.protocol.broadcast(self._node.protocol.build_msg('ack'))\n",
    )
    assert analyze([], [SendUnderLockRule], sources={"commands/federation.py": src}) == []
    found = analyze([], [SendUnderLockRule], sources={"commands/federation.py": mutated})
    assert any(f.rule == "send-under-lock" for f in found)


def test_shipped_grpc_transport_flags_unguarded_xp():
    _src, mutated = _mutate(
        "communication/grpc_transport.py",
        "    if msg.xp is not None:\n"
        "        # experiment identity (Node.set_start_learning) — optional like\n"
        "        # \"tc\": old frames decode unchanged, receivers use it to filter\n"
        "        # cross-experiment stragglers exactly\n"
        "        d[\"xp\"] = msg.xp\n",
        "    d[\"xp\"] = msg.xp\n",
    )
    found = analyze([], [WireHeaderCompatRule], sources={"communication/grpc_transport.py": mutated})
    assert any("serialized unconditionally" in f.message for f in found)


def test_shipped_memory_flags_dropped_version_copy():
    _src, mutated = _mutate("communication/memory.py", "        version=env.update.version,\n", "")
    found = analyze([], [WireHeaderCompatRule], sources={"communication/memory.py": mutated})
    assert any("without copying 'version'" in f.message for f in found)


def test_shipped_proto_wire_flags_vv_leak():
    _src, mutated = _mutate(
        "communication/proto_wire.py",
        "        cmd=env.cmd,\n    ).SerializeToString()",
        "        cmd=env.cmd,\n        vv=list(env.update.version or ()),\n    ).SerializeToString()",
    )
    found = analyze([], [WireHeaderCompatRule], sources={"communication/proto_wire.py": mutated})
    assert any("protobuf interop codec" in f.message for f in found)


def test_shipped_codecs_are_clean_as_a_set():
    """The three shipped codec files, as the one codec set they are."""
    rels = ("communication/grpc_transport.py", "communication/memory.py", "communication/proto_wire.py")
    assert analyze([], [WireHeaderCompatRule], sources={rel: _read(rel) for rel in rels}) == []


@pytest.mark.parametrize("probe, named", [
    ("    _shape_probe = update.params[next(iter(update.params))].cpu()\n", ".cpu()"),
    ("    _digest = tree_leaves(update.params)[0].numpy().tobytes()\n", ".numpy()"),
    ("    _n = int(tree_leaves(update.params)[0].sum().item())\n", ".item()"),
])
def test_shipped_ici_flags_host_gather_reintroduced(probe, named):
    needle = "    src = proto.get_address()\n"
    src, mutated = _mutate("communication/ici.py", needle, needle + probe)
    assert analyze([], [NoHostGatherRule], sources={"communication/ici.py": src}) == []
    found = analyze([], [NoHostGatherRule], sources={"communication/ici.py": mutated})
    assert any(f.rule == "no-host-gather" and f.message.startswith(named) for f in found)


def test_shipped_ici_plane_flags_host_copy_reintroduced():
    needle = "    fillers = tree_leaves(filler)\n"
    glue, mutated = _mutate("parallel/ici_plane.py", needle, needle + "    _host = [x.to('cpu') for _, x in items]\n")
    assert analyze([], [NoHostGatherRule], sources={"parallel/ici_plane.py": glue}) == []
    found = analyze([], [NoHostGatherRule], sources={"parallel/ici_plane.py": mutated})
    assert any(f.message.startswith(".to('cpu')") for f in found)


# ---- suppression ----

BAD_SEND = """
class H:
    def f(self):
        with self.lock:
            self.protocol.send(self.peer, self.env){pragma}
"""


@pytest.mark.parametrize("pragma, flagged", [
    ("  # p2pfl: allow(send-under-lock) — teeth test", []),
    ("  # p2pfl: allow(*) — drive harness", []),
    ("  # p2pfl: allow(monotone-merge)", ["send-under-lock"]),
    ("", ["send-under-lock"]),
])
def test_inline_suppression(pragma, flagged):
    assert rules_of(analyze([], ALL_RULES, sources={"a.py": BAD_SEND.format(pragma=pragma)})) == flagged


def test_inline_suppression_line_above():
    src = (
        "class H:\n"
        "    def f(self):\n"
        "        with self.lock:\n"
        "            # p2pfl: allow(send-under-lock) — justified\n"
        "            self.protocol.send(self.peer, self.env)\n"
    )
    assert analyze([], ALL_RULES, sources={"a.py": src}) == []


# ---- baseline ----


def test_baseline_accepts_old_findings_only(tmp_path):
    src = BAD_SEND.format(pragma="")
    found = analyze([], ALL_RULES, sources={"a.py": src})
    assert len(found) == 1
    baseline_file = tmp_path / "baseline.json"
    write_baseline(str(baseline_file), found)
    baseline = load_baseline(str(baseline_file))
    assert new_findings(found, baseline) == []
    src2 = src + "\n    def g(self):\n        with self.lock:\n            self.protocol.broadcast(self.env)\n"
    fresh = new_findings(analyze([], ALL_RULES, sources={"a.py": src2}), baseline)
    assert [f.context for f in fresh] == ["H.g"]


def test_fingerprint_survives_line_shifts():
    src = BAD_SEND.format(pragma="")
    (f1,) = analyze([], ALL_RULES, sources={"a.py": src})
    (f2,) = analyze([], ALL_RULES, sources={"a.py": "# a new header comment\n\n" + src})
    assert f1.line != f2.line
    assert f1.fingerprint == f2.fingerprint


def test_missing_baseline_is_empty(tmp_path):
    assert load_baseline(str(tmp_path / "none.json")) == {}


def test_findings_format_and_severity():
    f = Finding(rule="r", path="p.py", line=3, col=4, message="m")
    assert f.format() == "p.py:3:4: error[r] m" and f.severity is Severity.ERROR
    assert format_findings([Finding("r", "b.py", 1, 0, "x"), f]).splitlines()[0].startswith("b.py")


# ---- the CLI ----


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD_SEND.format(pragma=""))
    good = tmp_path / "good.py"
    good.write_text("def f():\n    return 1\n")
    assert cli_main([str(good)]) == 0
    assert cli_main([str(bad)]) == 1
    assert cli_main([str(tmp_path / "missing.py")]) == 2
    assert cli_main(["--select", "not-a-rule", str(good)]) == 2
    assert cli_main(["--select", "donation-reuse", str(good)]) == 2  # not ported: no donated buffers
    baseline = tmp_path / "b.json"
    assert cli_main([str(bad), "--baseline", str(baseline), "--update-baseline"]) == 0
    assert cli_main([str(bad), "--baseline", str(baseline)]) == 0
    assert cli_main([str(bad), "--select", "send-under-lock", "--update-baseline"]) == 2
    capsys.readouterr()
    assert cli_main([str(bad), "--json", "--select", "send-under-lock"]) == 1
    import json

    rows = json.loads(capsys.readouterr().out)
    assert [r["rule"] for r in rows] == ["send-under-lock"] and rows[0]["baselined"] is False


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == [
        "send-under-lock", "monotone-merge", "wire-header-compat", "no-host-gather"]


def test_cli_default_path_is_the_port(monkeypatch, capsys):
    monkeypatch.chdir(PKG.parent)
    assert cli_main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().err


# ---- the self-run gate ----


def test_self_run_is_green():
    """``python -m p2pfl_tpu_torch.analysis p2pfl_tpu_torch`` finds nothing."""
    found = analyze([str(PKG)], ALL_RULES)
    gating = [f for f in found if f.severity is Severity.ERROR]
    assert gating == [], "p2pfl-check found violations in the port:\n" + "\n".join(f.format() for f in gating)
