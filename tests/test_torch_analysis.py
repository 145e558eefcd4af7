"""repro_torch.analysis: per-checker fixture tests, the port's self-scan,
the seeded regressions, and parity with repro.analysis.

The fixtures under ``tests/analysis_fixtures_torch/`` are torch source that
is only parsed, never imported. Each bad fixture marks every expected
finding with a ``# RAnnn`` comment on its line (``xN`` for N on one line).
"""
import os
import re
import subprocess
import sys
from collections import Counter

import pytest

from repro_torch.analysis import run_checks, scan
from repro_torch.analysis.core import Baseline

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "analysis_fixtures_torch")
REF_FIXTURES = os.path.join(TESTS, "analysis_fixtures")
PORT = os.path.join(REPO, "src", "repro_torch")
REF = os.path.join(REPO, "src", "repro")


def fixture_codes(name):
    findings = run_checks([os.path.join(FIXTURES, name)], REPO)
    return Counter(f.code for f in findings)


@pytest.fixture(scope="module")
def port_scan():
    return scan([PORT], REPO)


# -- host-sync (RA101) -------------------------------------------------------


def test_host_sync_bad_flags_item_conversions_and_np_materialization():
    codes = fixture_codes("host_sync_bad.py")
    assert codes["RA101"] == 3
    assert set(codes) == {"RA101"}


def test_host_sync_good_is_clean():
    assert not fixture_codes("host_sync_good.py")


def test_host_sync_reaches_through_the_call_graph():
    findings = run_checks([os.path.join(FIXTURES, "host_sync_bad.py")], REPO)
    assert any("helper" in f.message for f in findings)


def test_host_sync_flags_data_shaped_ops_fetch_and_synchronize():
    assert fixture_codes("host_sync_ops_bad.py") == Counter({"RA101": 11})
    assert not fixture_codes("host_sync_ops_good.py")


# -- retrace (RA201/RA202) ---------------------------------------------------


def test_retrace_bad_flags_all_four_hazards_plus_branch():
    codes = fixture_codes("retrace_bad.py")
    assert codes["RA201"] == 4
    assert codes["RA202"] == 1


def test_retrace_good_is_clean():
    assert not fixture_codes("retrace_good.py")


# -- capture breaks (RA203) --------------------------------------------------


def test_capture_bad_flags_every_upload_form():
    assert fixture_codes("capture_bad.py") == Counter({"RA203": 6})


def test_capture_good_uploads_before_the_region_is_clean():
    assert not fixture_codes("capture_good.py")


# -- lock discipline (RA301) -------------------------------------------------


def test_locks_bad_flags_unguarded_access():
    codes = fixture_codes("locks_bad.py")
    assert codes["RA301"] == 1
    assert set(codes) == {"RA301"}


def test_locks_good_accepts_lock_condition_alias_and_holds():
    assert not fixture_codes("locks_good.py")


# -- in-place aliasing (RA401) -----------------------------------------------


def test_donation_bad_flags_a_stale_alias_of_an_in_place_buffer():
    codes = fixture_codes("donation_bad.py")
    assert codes["RA401"] == 1
    assert set(codes) == {"RA401"}


def test_donation_good_clone_or_fresh_read_is_clean():
    assert not fixture_codes("donation_good.py")


def test_mutator_registry_is_built_from_the_port_itself(port_scan):
    from repro_torch.analysis.checkers.donation import mutator_registry

    reg = mutator_registry(port_scan.project)
    names = {
        fi.qualname: reg[key]
        for mod in port_scan.project.modules
        for infos in mod.defs.values()
        for fi in infos
        if (key := id(fi.node)) in reg
    }
    assert ("bank", "buf") in names["_bank_scatter"]
    assert ("bank", "d_last_access") in names["_bank_scatter"]  # through _bank_counter_set
    assert {("last", ""), ("cnt", "")} <= names["_bank_touch"]
    assert ("bank", "d_expires") in names["_bank_free"]
    assert ("part", "valid") in names["_part_scatter"]


# -- overflow/dtype (RA501/RA502) --------------------------------------------


def test_overflow_bad_flags_unguarded_counter_and_f32_timestamps():
    codes = fixture_codes("overflow_bad.py")
    assert codes["RA501"] == 1
    assert codes["RA502"] == 2


def test_overflow_good_is_clean():
    assert not fixture_codes("overflow_good.py")


def test_narrowing_bad_flags_torch_forms_and_good_is_clean():
    assert fixture_codes("narrowing_bad.py") == Counter({"RA502": 4})
    assert not fixture_codes("narrowing_good.py")


# -- device regions: the static[...] marker and the unmarked roots -----------


def test_static_marker_bad_without_statics_flags_python_flags():
    assert fixture_codes("static_bad.py") == Counter({"RA101": 2, "RA202": 1})


def test_static_marker_good_holds_the_python_values_of_regions():
    assert not fixture_codes("static_good.py")


def test_autograd_module_and_captured_callables_are_regions():
    sc = scan([os.path.join(FIXTURES, "roots_bad.py")], REPO)
    kinds = Counter(r.kind for r in sc.project.roots)
    assert kinds == Counter({"autograd": 2, "module": 1, "graph": 2})
    assert Counter(f.code for f in sc.findings) == Counter({"RA101": 3, "RA202": 1})


BAD_FIXTURES = sorted(f for f in os.listdir(FIXTURES) if f.endswith("_bad.py"))
_MARK = re.compile(r"#\s*(RA\d{3})\b(?:[^#]*?\bx(\d+))?")


@pytest.mark.parametrize("name", BAD_FIXTURES)
def test_bad_fixture_findings_sit_on_their_marked_lines(name):
    path = os.path.join(FIXTURES, name)
    want = Counter()
    with open(path) as fh:
        for ln, text in enumerate(fh, 1):
            for code, n in _MARK.findall(text):
                want[(ln, code)] += int(n or 1)
    got = Counter((f.line, f.code) for f in run_checks([path], REPO))
    assert got == want


# -- the port's own tree -----------------------------------------------------


def test_port_is_clean_with_no_baseline(port_scan):
    assert not port_scan.findings, "new findings:\n" + "\n".join(
        f.render() for f in port_scan.findings)


def test_every_suppression_in_the_port_carries_its_reason(port_scan):
    by_rel = {m.src.rel: m.src for m in port_scan.project.modules}
    assert port_scan.suppressed
    for f in port_scan.suppressed:
        comment = by_rel[f.path].comments[f.line]
        assert re.search(r"noqa\[[A-Z0-9, ]+\]\s*[—-]+\s*\w", comment), f.render()


def test_port_regions_cover_the_read_path_and_the_models(port_scan):
    p = port_scan.project
    roots = {(r.func.module.src.rel, r.func.qualname) for r in p.roots}
    rp = "src/repro_torch/core/read_path.py"
    sb = "src/repro_torch/core/store_bank.py"
    for want in [(rp, "run_program"), (rp, "decide"), (sb, "_bank_touch"),
                 (sb, "fused_search_body"),
                 ("src/repro_torch/distributed/sharded_read.py", "sharded_program"),
                 ("src/repro_torch/models/transformer.py", "decode_step"),
                 ("src/repro_torch/kernels/flash_attention/kernel.py", "FlashAttentionFn.forward"),
                 ("src/repro_torch/core/embeddings.py", "ContrieverEncoder.forward")]:
        assert want in roots, want
    device = {(fi.module.src.rel, fi.qualname) for fi in p.device_funcs.values()}
    assert (rp, "_search") in device and (rp, "_lifecycle") in device
    assert ("src/repro_torch/distributed/sharded_read.py", "_touch") in device
    # a compile cache's body is host code built once per key
    assert (rp, "make_decide") not in device


def test_static_names_of_run_program_are_host_values(port_scan):
    from repro_torch.analysis.project import HOST, TENSOR

    p = port_scan.project
    fi = next(r.func for r in p.roots if r.func.qualname == "run_program")
    for name in ("specs", "K", "use_kernel", "lifecycle", "tick", "now"):
        assert p.param_kind(fi, name) == HOST, name
    for name in ("forward", "embed_args", "thresholds", "qmask"):
        assert p.param_kind(fi, name) == TENSOR, name


def test_cli_exits_nonzero_on_findings_and_zero_when_clean(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x):  # repro: device-region\n    return x.item()\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(bad), "--root", str(tmp_path)],
        capture_output=True, text=True, env=env,
    )
    assert r.returncode == 1
    assert "RA101" in r.stdout
    assert "1 new finding" in r.stdout

    good = tmp_path / "good.py"
    good.write_text("def f(x):\n    return x + 1\n")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(good), "--root", str(tmp_path)],
        capture_output=True, text=True, env=env,
    )
    assert r.returncode == 0
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(tmp_path / "missing.py")],
        capture_output=True, text=True, env=env,
    )
    assert r.returncode == 2


def test_cli_default_path_is_the_port_and_exits_zero():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--root", REPO],
                       capture_output=True, text=True, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout
    assert "0 new finding(s)" in r.stdout


def _seed(tmp_path, rel, anchor, insert, after=True):
    with open(os.path.join(PORT, rel)) as fh:
        lines = fh.read().split("\n")
    at = [i for i, ln in enumerate(lines) if ln.startswith(anchor)]
    assert len(at) == 1, f"{rel}: anchor moved; update the test"
    lines.insert(at[0] + 1 if after else at[0], insert)
    target = tmp_path / (os.path.basename(rel)[:-3] + "_seeded.py")
    target.write_text("\n".join(lines))
    return run_checks([str(target)], str(tmp_path))


def test_seeded_regression_item_inside_the_decide_stage_is_caught(tmp_path):
    """The CI gate the suite exists for: an .item() smuggled into the read
    program's decide stage must come back as a finding."""
    findings = _seed(tmp_path, "core/read_path.py", "    def decide(s, thresholds, qmask):",
                     "        _leak = s.item()")
    assert any(f.code == "RA101" and ".item()" in f.message and "decide" in f.message
               for f in findings), [f.render() for f in findings]


def test_seeded_regression_upload_inside_run_program_is_caught(tmp_path):
    findings = _seed(tmp_path, "core/read_path.py", "    q = forward(*embed_args)",
                     "    _up = torch.as_tensor(np.zeros(1, np.float32), device=bank.device)",
                     after=False)
    assert any(f.code == "RA203" and "run_program" in f.message
               for f in findings), [f.render() for f in findings]


def test_seeded_regression_upload_inside_the_sharded_program_is_caught(tmp_path):
    findings = _seed(tmp_path, "distributed/sharded_read.py",
                     "    q = forward(*embed_args)",
                     "    _now = torch.tensor(now, device=srb.device)", after=False)
    assert any(f.code == "RA203" and "sharded_program" in f.message
               for f in findings), [f.render() for f in findings]


def test_noqa_suppresses_a_finding(tmp_path):
    bad = tmp_path / "sup.py"
    bad.write_text(
        "def f(x):  # repro: device-region\n"
        "    return x.item()  # repro: noqa[RA101] — test suppression\n"
    )
    assert not run_checks([str(bad)], str(tmp_path))
    assert [f.code for f in scan([str(bad)], str(tmp_path)).suppressed] == ["RA101"]


def test_baseline_keys_survive_line_drift(tmp_path):
    bad = tmp_path / "drift.py"
    bad.write_text("def f(x):  # repro: device-region\n    return x.item()\n")
    findings = run_checks([str(bad)], str(tmp_path))
    baseline_file = tmp_path / "base.txt"
    Baseline.write(str(baseline_file), findings)
    # shift the finding down two lines; the baseline key must still match
    bad.write_text("# pad\n# pad\ndef f(x):  # repro: device-region\n    return x.item()\n")
    drifted = run_checks([str(bad)], str(tmp_path))
    new, old, stale = Baseline.load(str(baseline_file)).split(drifted)
    assert not new and len(old) == 1 and not stale


# -- parity with repro.analysis ----------------------------------------------


def test_framework_parity_keys_noqa_modname_and_drift(tmp_path):
    from repro.analysis import core as ref_core
    from repro_torch.analysis import core as port_core

    source = ("import x\n"
              "a = 1  # repro: noqa[RA101, RA203] — reason\n"
              "b = 2  # repro: noqa[*]\n"
              "c = 3  # guarded-by: _lock\n")
    for rel in ("src/repro_torch/core/read_path.py", "src/pkg/__init__.py", "tests/t.py"):
        r = ref_core.SourceModule(rel, rel, source)
        p = port_core.SourceModule(rel, rel, source)
        assert r.noqa == p.noqa and r.comments == p.comments and r.modname == p.modname
        assert [r.suppressed(2, c) for c in ("RA101", "RA301")] == [
            p.suppressed(2, c) for c in ("RA101", "RA301")]
        assert r.suppressed(3, "RA999") and p.suppressed(3, "RA999")
    f_ref = ref_core.Finding("a.py", 7, "RA101", "msg")
    f_port = port_core.Finding("a.py", 9, "RA101", "msg")
    assert f_ref.baseline_key == f_port.baseline_key
    assert f_ref.render().replace(":7:", ":9:") == f_port.render()
    keys = {f_ref.baseline_key, "gone.py: RA202 stale"}
    new_r, old_r, stale_r = ref_core.Baseline(set(keys)).split([f_ref])
    new_p, old_p, stale_p = port_core.Baseline(set(keys)).split([f_port])
    assert (len(new_r), len(old_r), stale_r) == (len(new_p), len(old_p), stale_p)


def _raw(run, path, codes, monkeypatch, core):
    """Findings of ``codes`` with inline suppressions switched off."""
    monkeypatch.setattr(core.SourceModule, "suppressed", lambda self, line, code: False)
    return sorted((f.path, f.line, f.code, f.message) for f in run([path], REPO)
                  if f.code in codes)


@pytest.mark.parametrize("name", ["locks_bad.py", "locks_good.py", "overflow_bad.py",
                                  "overflow_good.py"])
def test_ra301_ra50x_parity_on_the_reference_fixtures(name, monkeypatch):
    from repro.analysis import core as ref_core
    from repro.analysis import run_checks as ref_run
    from repro_torch.analysis import core as port_core

    path = os.path.join(REF_FIXTURES, name)
    codes = {"RA301", "RA501", "RA502"}
    ref = _raw(ref_run, path, codes, monkeypatch, ref_core)
    port = _raw(run_checks, path, codes, monkeypatch, port_core)
    assert [f[:3] for f in ref] == [f[:3] for f in port]
    assert [f[3] for f in ref if f[2] == "RA301"] == [f[3] for f in port if f[2] == "RA301"]


def test_ra301_ra501_parity_on_the_port(monkeypatch):
    from repro.analysis import core as ref_core
    from repro.analysis import run_checks as ref_run
    from repro_torch.analysis import core as port_core

    codes = {"RA301", "RA501"}
    ref = _raw(ref_run, PORT, codes, monkeypatch, ref_core)
    port = _raw(run_checks, PORT, codes, monkeypatch, port_core)
    assert ref == port
    assert len(port) == 2  # the two suppressed RA301s of core/client.py


# The reference's 32 device roots (repro.analysis.project.ProjectIndex on
# src/repro: jax.jit / shard_map targets, keyed by file, qualname and line)
# and the port's region that stands for each.
_T = "src/repro_torch/"
ROOT_TWINS = {
    ("core/embeddings.py", "<lambda>", 186): (
        _T + "core/embeddings.py", "ContrieverEncoder.forward"),
    ("core/read_path.py", "program", 203): (_T + "core/read_path.py", "run_program"),
    ("core/read_path.py", "program_lc", 213): (_T + "core/read_path.py", "run_program"),
    ("core/store_bank.py", "_bank_scatter", 149): (_T + "core/store_bank.py", "_bank_scatter"),
    ("core/store_bank.py", "_bank_counter_set", 173): (
        _T + "core/store_bank.py", "_bank_counter_set"),
    ("core/store_bank.py", "_bank_free", 185): (_T + "core/store_bank.py", "_bank_free"),
    ("core/store_bank.py", "_bank_touch", 201): (_T + "core/store_bank.py", "_bank_touch"),
    ("core/store_bank.py", "fused_search_body", 232): (
        _T + "core/store_bank.py", "fused_search_body"),
    # _lane_search_jnp's jit: search_lane runs fused_search_body on the lane
    ("core/store_bank.py", "fn", 259): (_T + "core/store_bank.py", "fused_search_body"),
    # _lane_search_pallas's jit: search_lane's kernel route is B2
    ("core/store_bank.py", "fn", 271): (_T + "kernels/similarity_topk/ops.py", "similarity_topk"),
    ("distributed/sharded_read.py", "body", 114): (
        _T + "distributed/sharded_read.py", "sharded_program"),
    # both shard_map local_lookups, and the no-axes jits, are one lookup
    ("distributed/sharded_store.py", "local_lookup", 106): (
        _T + "distributed/sharded_store.py", "lookup"),
    ("distributed/sharded_store.py", "local_lookup", 164): (
        _T + "distributed/sharded_store.py", "lookup"),
    ("distributed/sharded_store.py", "<lambda>", 102): (
        _T + "distributed/sharded_store.py", "lookup"),
    ("distributed/sharded_store.py", "flat", 151): (_T + "distributed/sharded_store.py", "lookup"),
    ("distributed/sharded_store.py", "_scatter", 247): (
        _T + "distributed/sharded_store.py", "_part_scatter"),
    ("distributed/sharded_store.py", "_free", 272): (_T + "core/store_bank.py", "_bank_free"),
    # the Pallas bodies became CUDA sources; their launch wrappers are regions
    ("kernels/decode_attention/kernel.py", "decode_attention_kernel", 78): (
        _T + "kernels/decode_attention/kernel.py", "decode_attention_cuda"),
    ("kernels/decode_attention/ops.py", "_decode_attention", 17): (
        _T + "kernels/decode_attention/ops.py", "decode_attention"),
    ("kernels/flash_attention/kernel.py", "flash_attention_kernel", 98): (
        _T + "kernels/flash_attention/kernel.py", "flash_attention_cuda"),
    ("kernels/flash_attention/ops.py", "_flash_attention", 19): (
        _T + "kernels/flash_attention/ops.py", "flash_attention"),
    ("kernels/similarity_topk/kernel.py", "similarity_topk_lanes_blocks", 84): (
        _T + "kernels/similarity_topk/kernel.py", "similarity_topk_lanes_blocks"),
    # B2 is B1's kernel at L = 1
    ("kernels/similarity_topk/kernel.py", "similarity_topk_blocks", 141): (
        _T + "kernels/similarity_topk/ops.py", "similarity_topk"),
    ("kernels/similarity_topk/ops.py", "_similarity_topk", 118): (
        _T + "kernels/similarity_topk/ops.py", "similarity_topk"),
    ("kernels/similarity_topk/ops.py", "_similarity_topk_lanes", 169): (
        _T + "kernels/similarity_topk/ops.py", "_similarity_topk_lanes"),
    ("kernels/ssd_scan/kernel.py", "ssd_scan_kernel", 75): (
        _T + "kernels/ssd_scan/kernel.py", "ssd_scan_cuda"),
    ("kernels/ssd_scan/ops.py", "_ssd_scan", 15): (_T + "kernels/ssd_scan/ops.py", "ssd_scan"),
    ("launch/dryrun.py", "prefill_fn", 102): (_T + "launch/dryrun.py", "_run"),
    ("launch/dryrun.py", "decode_fn", 117): (_T + "launch/dryrun.py", "_run"),
    ("models/moe.py", "local_fn", 191): (_T + "models/moe.py", "_moe_ffn_sharded"),
    ("serving/engine.py", "<lambda>", 73): (_T + "models/transformer.py", "decode_step"),
    ("serving/engine.py", "fn", 82): (_T + "models/transformer.py", "prefill"),
}


def test_every_reference_root_has_a_port_region(port_scan):
    from repro.analysis.core import collect_modules as ref_collect
    from repro.analysis.project import ProjectIndex as RefIndex

    ref = RefIndex(ref_collect([REF], REPO))
    keys = {(r.func.module.src.rel[len("src/repro/"):], r.func.qualname, r.func.node.lineno)
            for r in ref.jit_roots}
    assert len(ref.jit_roots) == 32 and keys == set(ROOT_TWINS)
    port_roots = {(r.func.module.src.rel, r.func.qualname) for r in port_scan.project.roots}
    missing = {k: v for k, v in ROOT_TWINS.items() if v not in port_roots}
    assert not missing, missing


def test_port_analysis_imports_neither_jax_nor_the_reference():
    pkg = os.path.join(PORT, "analysis")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", text, re.M), f
