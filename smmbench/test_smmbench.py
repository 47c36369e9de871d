"""CPU tests of the benchmark: every cell at a tiny size through the same
harness, new cells and metrics from files alone, the work counts, the
reference's verdicts on broken answers and on the bf16 control, the
forbidden modules, and the trace's reading.

    python -m pytest smmbench -q
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import sys
import types

import pytest
import torch

from smmbench import entries, harness, operands, run, tracing, work
from smmbench.reference import compare, products

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
TINY = {"readme_10k": {"rows": 48, "cols": 48, "nnz": 460},
        "er_200k": {"rows": 2000, "cols": 2000, "nnz": 20000}}


def _manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark whose configurations are cut to tiny sizes."""
    shutil.copytree(BENCH_DIR, tmp_path / "smmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*.py"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    for entry in _manifest()["configs"]:
        path = tmp_path / entry["file"]
        config = json.loads(path.read_text())
        for spec in config["operands"].values():
            spec.update(TINY[entry["name"]])
        path.write_text(json.dumps(config))
    return tmp_path


def _run(root, workload, **kw):
    kw.setdefault("seed", 2**40 + 3)
    kw.setdefault("seconds", 0.2)
    kw.setdefault("trace", False)
    return harness.run(str(root), workload, device="cpu", log=sys.stdout, **kw)


@pytest.mark.parametrize("workload", [w["name"] for w in _manifest()["workloads"]])
def test_each_cell_runs_correct_at_a_tiny_size(tiny_root, workload):
    result = _run(tiny_root, workload)
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"entries_per_s", "call_ms_p95", "setup_s"} <= set(result["metrics"])
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("workload", [w["name"] for w in _manifest()["workloads"]])
def test_the_bf16_control_reads_incorrect(tiny_root, workload):
    result = _run(tiny_root, workload, control=True)
    assert result["correct"] is False
    assert result["checks"]["value_share"]["value"] > 10


def test_a_new_config_traffic_and_metric_are_files_alone(tiny_root):
    (tiny_root / "smmbench/configs/rect.json").write_text(json.dumps(dict(
        name="rect", dtype="float32", rtol=1e-5, atol=1e-8, operands=dict(
            a=dict(rows=40, cols=64, nnz=300), q=dict(rows=64, cols=64, nnz=500)))))
    (tiny_root / "smmbench/traffic/triple_upper.json").write_text(json.dumps(dict(
        entry="triple_product", operands=["a", "q"], kwargs=dict(compute_full_matrix=0))))
    (tiny_root / "smmbench/metrics/call_ms_max.py").write_text(
        "def read(ctx):\n    return max(ctx.call_s) * 1e3 if ctx.call_s else None\n")
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(name="rect", source="a test", file="smmbench/configs/rect.json",
                                    reduced=[], why="a test"))
    manifest["workloads"].append(dict(name="rect.triple_upper", config="rect",
                                      traffic="triple_upper", chips=1, why="a test"))
    manifest["end_to_end"].append(dict(name="call_ms_max", unit="ms", better="lower", bound=0.1,
                                       source="host_clock", workloads=["rect.triple_upper"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(manifest))
    result = _run(tiny_root, "rect.triple_upper")
    assert result["correct"] is True
    assert result["metrics"]["call_ms_max"]["value"] >= result["metrics"]["call_ms_p95"]["value"]
    assert "asymmetry" not in result["checks"]


def _broken(monkeypatch, fault):
    """The timed path broken underneath: ``fault(answer, call)`` alters what
    the port's entry returned."""
    program = entries.Subject._program
    state = {}

    def broken(self):
        state["call"] = state.get("call", -1) + 1
        return fault(program(self), state)
    monkeypatch.setattr(entries.Subject, "_program", broken)


def _alter_value(answer, state):
    if isinstance(answer, torch.Tensor):
        answer[0, 0] *= 1 + 1e-4
    else:
        answer.values[0] *= 1 + 1e-4
    return answer


def _drop_last_entry(answer, state):
    answer.indptr[-1] -= 1
    return answer


def _stale(answer, state):
    """The first answer of the run returned for every later call."""
    return state.setdefault("first", answer)


@pytest.mark.parametrize("fault", [_alter_value, _drop_last_entry, _stale])
@pytest.mark.parametrize("workload", ["readme_10k.sym_csr", "er_200k.csr"])
def test_a_broken_answer_reads_incorrect(tiny_root, monkeypatch, fault, workload):
    _broken(monkeypatch, fault)
    assert _run(tiny_root, workload)["correct"] is False


@pytest.mark.parametrize("fault", [_alter_value, _stale])
def test_a_broken_dense_answer_reads_incorrect(tiny_root, monkeypatch, fault):
    _broken(monkeypatch, fault)
    assert _run(tiny_root, "readme_10k.triple_full")["correct"] is False


def test_a_broken_mirror_reads_incorrect(tiny_root, monkeypatch):
    def lower_off(answer, state):
        answer[-1, 0] += 1.0
        return answer
    _broken(monkeypatch, lower_off)
    result = _run(tiny_root, "readme_10k.triple_full")
    assert result["correct"] is False and result["checks"]["asymmetry"]["value"] > 0


def test_a_bf16_rounded_answer_is_refused():
    g = operands.generator("cpu", 5, "test")
    a = operands.Csr(*operands.structure(30, 30, 200, g, "cpu"),
                     operands.values(200, g, torch.float32, "cpu"), (30, 30))
    ref = products.product(a, a)
    rounded = ref._replace(values=ref.values.to(torch.bfloat16).to(torch.float64))
    sound = compare.csr_reading(ref._replace(values=ref.values.float()),
                                products.product_blocks(a, a), 30, 1e-5, 1e-8)
    bad = compare.csr_reading(rounded, products.product_blocks(a, a), 30, 1e-5, 1e-8)
    assert sound == dict(structure_mismatch=0, value_share=pytest.approx(0, abs=0.1))
    assert bad["structure_mismatch"] == 0 and bad["value_share"] > 10


def test_the_reference_blocks_agree_with_one_dense_product(monkeypatch):
    g = operands.generator("cpu", 9, "test")
    a = operands.Csr(*operands.structure(50, 40, 300, g, "cpu"),
                     operands.values(300, g, torch.float32, "cpu"), (50, 40))
    b = operands.Csr(*operands.structure(40, 60, 200, g, "cpu"),
                     operands.values(200, g, torch.float32, "cpu"), (40, 60))
    want = torch.triu(products.dense(a, products.F64) @ products.dense(b, products.F64))
    monkeypatch.setattr(products, "ESC_BLOCK_PARTIALS", 64)
    monkeypatch.setattr(products, "DENSE_BLOCK_ELEMENTS", 7 * 60)
    for blocks in (products._esc_blocks(a, b, True, products.F64),
                   products._dense_blocks(a, b, True, products.F64)):
        got = torch.zeros(50, 60, dtype=torch.float64)
        for r0, r1, blk in blocks:
            rows = products.row_ids(blk.indptr) + r0
            got[rows, blk.indices] = blk.values
        assert torch.allclose(got, want, rtol=1e-12, atol=0)


def test_operands_are_distinct_sorted_and_drawn_from_the_seed():
    seed = 2**70 + 11
    p1, i1 = operands.structure(100, 90, 2000, operands.generator("cpu", seed, "x"), "cpu")
    p2, i2 = operands.structure(100, 90, 2000, operands.generator("cpu", seed, "x"), "cpu")
    assert torch.equal(p1, p2) and torch.equal(i1, i2)
    keys = products.row_ids(p1) * 90 + i1
    assert int(p1[-1]) == 2000 and torch.all(keys[1:] > keys[:-1])
    full, _ = operands.structure(4, 5, 20, operands.generator("cpu", 1, "x"), "cpu")
    assert int(full[-1]) == 20
    v = operands.values(10_000, operands.generator("cpu", seed, "v"), torch.float32, "cpu")
    assert float(v.min()) > 0 and float(v.max()) <= 1


def test_work_counts_by_hand():
    assert work.triu_entries(3, 3) == 6 and work.triu_entries(2, 4) == 7
    assert work.gemm_upper(3, 3, 2) == dict(bytes=4 * (6 + 6 + 6), flops=2 * 6 * 2)
    assert work.gemm_full(2, 3, 4) == dict(bytes=4 * (8 + 12 + 6), flops=2 * 2 * 3 * 4)
    assert work.extract_upper(3, 3, 5) == dict(bytes=4 * 6 + 4 * 4 + 8 * 5, flops=0)
    assert work.extract_full(2, 3, 4) == dict(bytes=4 * 6 + 4 * 3 + 8 * 4, flops=0)
    sym = work.entry_work("multiply", dict(symmetric=True), [(3, 2), (2, 3)], 5)
    assert sym == dict(gemm=work.gemm_upper(3, 3, 2), extract=work.extract_upper(3, 3, 5))
    triple = work.entry_work("triple_product", {}, [(4, 5), (5, 5)], 16)
    assert triple["gemm"]["flops"] == 2 * 4 * 5 * 5 + 2 * work.triu_entries(4, 4) * 5
    # 10,000^2 triangle: 1.0001e12 operations, 1.011 ms at one bf16 pass.
    ten_k = work.gemm_upper(10_000, 10_000, 10_000)
    assert ten_k["flops"] == 2 * 50_005_000 * 10_000
    assert work.least_seconds(ten_k) == pytest.approx(1.0001e12 / 989e12)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sparse_matrix_mult_tpu_torch_extra", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sparse_matrix_mult_tpu.api", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["sparse_matrix_mult_tpu.api"]


def test_a_loaded_jax_stops_the_run(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert _run(tiny_root, "readme_10k.csr") == dict(forbidden=["jax"])


def test_the_command_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "readme_10k.sym_csr", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "nothing was run" in out.err


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            names.update("." + (node.module or a.name) for a in node.names)
    return names


def test_no_module_imports_jax_or_the_jax_package():
    paths = [os.path.join(d, f) for d, _, fs in os.walk(BENCH_DIR) for f in fs if f.endswith(".py")]
    assert len(paths) > 10
    for path in paths:
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    reference = os.path.join(BENCH_DIR, "reference")
    plain = [os.path.join(BENCH_DIR, "operands.py")] + [
        os.path.join(reference, f) for f in os.listdir(reference) if f.endswith(".py")]
    for path in plain:
        names = _imports(path)
        assert "sparse_matrix_mult_tpu_torch" not in names, path
        assert not {".entries", ".harness", ".run"} & names, path


def test_the_trace_gives_each_operation_to_the_step_that_launched_it():
    host = [(0, 100, tracing.STEP), (1, 60, tracing.CALL), (10, 12, "cudaLaunchKernel"),
            (20, 22, "cudaLaunchKernel"), (30, 35, "cudaStreamSynchronize"),
            (100, 110, "refresh"), (105, 106, "cudaLaunchKernel"),
            (110, 200, tracing.STEP), (111, 150, tracing.CALL), (120, 122, "cudaLaunchKernel"),
            (150, 200, "cudaDeviceSynchronize")]
    # The card's clock runs 40 us behind the host's: the second step's
    # kernel reads as if it ran in the first.
    ops = [(0, 40, "triu_gemm_kernel<3>", 10), (40, 50, "fill_rows<float, true>", 20),
           (66, 68, "distribution_kernel", 105), (90, 150, "triu_gemm_kernel<3>", 120)]
    kmap = {"gemm": ["triu_gemm_kernel"], "extract": ["fill_rows"]}
    first = tracing.read(ops, host, kmap, skip_steps=0)
    assert first.calls == 2 and first.window_s == pytest.approx(190e-6)
    assert first.busy_s == pytest.approx(110e-6)
    assert first.stage_s == dict(gemm=pytest.approx(100e-6), extract=pytest.approx(10e-6))
    assert first.unknown_s == {} and first.host_waits == 1
    assert sum(s for _, s in first.idle_gaps) == pytest.approx(first.window_s - first.busy_s)
    second = tracing.read(ops, host, kmap)
    assert second.calls == 1 and second.busy_s == pytest.approx(60e-6)


def test_the_reservoir_is_drawn_from_the_seed():
    def kept(seed):
        r = harness._Reservoir(4, seed)
        for call in range(500):
            r.offer(call, call)
        return sorted(r.kept)
    assert kept(3) == kept(3) and kept(3) != kept(4) and len(kept(3)) == 4
