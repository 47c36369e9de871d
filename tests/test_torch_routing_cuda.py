"""How the router decides on a CUDA device, checked on the CPU: the link
probe, the CUDA terms of the cost model, the ladder without the binned rung
and the BSR cutoff with its occupancy scan.

Nothing here needs a card.  A decision is made on the host, so a request
on ``"cuda"`` is driven here with the uploads kept on the CPU
(``from_scipy`` pinned to it, the stage clock's synchronize a no-op): every
engine runs its plain PyTorch version, and the route, the scans and the
products are those of a CUDA request.  On the CPU the router stays JAX's
(``tests/test_torch_cost_model.py`` holds it against the JAX package).
"""

import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu import api as japi
from sparse_matrix_mult_tpu_torch import api
from sparse_matrix_mult_tpu_torch.ops.spgemm_binned import BinnedPlan
from sparse_matrix_mult_tpu_torch.utils.transfer import fine_capacity
from sparse_matrix_mult_tpu_torch.utils.testing import hypersparse_random

ORACLE = dict(rtol=1e-5, atol=1e-8)
# A link of 2 ms fixed cost, 5 GB/s up and 2 GB/s down, and round host rates
# (fetch_np's host copy at 6 GB/s, fresh pages at 3 GB/s, a fetch_np
# result's at 4 GB/s, a copy of a host CSR's entries at 5e8/s; spgemm_host's
# entries at 1e8/s, those of A's one-entry rows at 4e8/s; scipy's row slice
# at 1.2e8 entries/s).
MODEL = dict(auto_calibrate_link=False, host_rate_base=1e8, link_fixed_s=2e-3,
             link_up_bytes_per_s=5e9, link_down_bytes_per_s=2e9, host_pack_rate=5e8,
             host_partial_rate=3e9, host_entry_rate=1e8, host_copy_entry_rate=4e8,
             host_csr_rate=2e8, host_slice_rate=1.2e8, esc_plan_rate=1.5e8,
             triu_rebuild_rate=7e7, host_f64_rate=3e8, dense_csr_rate=5e7,
             scipy_partial_rate=1.5e8, host_copy_rate=6e9, host_page_rate=3e9,
             host_fetch_page_rate=4e9, stitch_copy_rate=5e8,
             host_out_page_rate=1e9, host_upload_rate=4e8,
             esc_fixed_s=2e-3, esc_engine_rate=2e9)


@pytest.fixture
def config():
    saved_t, saved_j = tsmm.get_config(), jsmm.get_config()
    tsmm.set_config(**MODEL)
    jsmm.set_config(**{k: v for k, v in MODEL.items() if hasattr(jsmm.get_config(), k)})
    yield tsmm.set_config
    tsmm.set_config(saved_t)
    jsmm.set_config(saved_j)


@pytest.fixture
def on_cuda(monkeypatch):
    """Requests on ``"cuda"`` computed on the CPU: uploads stay there and the
    stage clock's synchronize does nothing."""
    real = api.from_scipy
    monkeypatch.setattr(api, "from_scipy", lambda *a, **kw: real(*a, **{**kw, "device": "cpu"}))
    real_args = BinnedPlan.device_args
    monkeypatch.setattr(BinnedPlan, "device_args", lambda plan, device: real_args(plan, "cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)


def _hyper(n=4000, nnz=40_000):
    return hypersparse_random(n, n, nnz, 1), hypersparse_random(n, n, nnz, 2)


def _operands(m, k, n, da, db, seed=0):
    if m * k > 10**8:  # sp.random samples every cell
        return (hypersparse_random(m, k, int(m * k * da), seed),
                hypersparse_random(k, n, int(k * n * db), seed + 1))
    return (sp.random(m, k, density=da, format="csr", random_state=seed),
            sp.random(k, n, density=db, format="csr", random_state=seed + 1))


# ---------------------------------------------------------------------------
# A. the link probe
# ---------------------------------------------------------------------------


class FakeClock:
    """perf_counter that reads out the given durations, one per timed call:
    each pair of readings spans the next duration."""

    def __init__(self, durations):
        self.stamps = iter([t for i, d in enumerate(durations) for t in (10.0 * i, 10.0 * i + d)])

    def perf_counter(self):
        return next(self.stamps)


def test_probe_takes_the_least_of_three_warmed_transfers(monkeypatch):
    """Each term is the least of three timed transfers after an untimed one,
    the download and upload net of the round trip; the routes' own fetch path
    is warmed once at the probe's size."""
    durations = [3e-5, 2e-5, 4e-5,  # round trips
                 1.3e-3, 1.1e-3, 1.2e-3,  # downloads (pinned host memory on CUDA)
                 1.6e-3, 1.4e-3, 1.5e-3]  # uploads
    fetched = []
    monkeypatch.setattr(api, "time", FakeClock(durations))
    monkeypatch.setattr(api, "fetch_np", lambda x: fetched.append(x) or x.numpy())
    monkeypatch.setattr(api, "_LINK_TERMS", {})
    terms = api._calibrate_link("cpu")
    assert terms == dict(link_fixed_s=pytest.approx(2e-5),
                         link_up_bytes_per_s=pytest.approx(api._PROBE_BYTES / (1.4e-3 - 2e-5)),
                         link_down_bytes_per_s=pytest.approx(api._PROBE_BYTES / (1.1e-3 - 2e-5)))
    assert [x.numel() * x.element_size() for x in fetched] == [api._PROBE_BYTES]
    assert api._LINK_TERMS["cpu"] is terms


def test_download_prices_the_link_the_copy_and_fresh_pages_on_cuda(config):
    """A CUDA route's download costs the link, the host copy into an array
    of the result's own dtype (the f64 cast fused into it) and that array's
    fresh pages; to_scipy's, the link, the copies of its int32 indices and
    f64 values, their fresh pages and the rest per entry.  The CPU's
    formula, JAX's, has none of the host terms."""
    a, b = _operands(3000, 3000, 3000, 0.001, 0.001)
    expand = 30_000
    nnz = api._est_result_nnz(expand, 3000, 3000)
    base = api._route_costs(expand, a, b, "cuda", request="dense_output")
    esc = api._route_costs(expand, a, b, "cuda", request="esc")
    config(host_copy_rate=1e300)
    free = api._route_costs(expand, a, b, "cuda", request="dense_output")
    assert base[0] == free[0]
    assert base[1] - free[1] == pytest.approx(8 * 3000 * 3000 / 6e9, rel=1e-9)
    no_copy = api._route_costs(expand, a, b, "cuda", request="esc")
    assert no_copy[0] == esc[0]
    assert esc[1] - no_copy[1] == pytest.approx(12 * nnz / 6e9, rel=1e-9)
    config(host_csr_rate=1e300)
    assert no_copy[1] - api._route_costs(expand, a, b, "cuda", request="esc")[1] == pytest.approx(
        nnz / 2e8, rel=1e-9)
    config(host_fetch_page_rate=1e300)  # the 72 MB panel lands in fresh pages, the entries do not
    assert free[1] - api._route_costs(expand, a, b, "cuda", request="dense_output")[1] == (
        pytest.approx(8 * 3000 * 3000 / 4e9, rel=1e-9))
    assert api._route_costs(expand, a, b, "cuda", request="esc")[1] == pytest.approx(
        no_copy[1] - nnz / 2e8, rel=1e-9)
    assert api._route_costs(expand, a, b, "cpu", request="esc") == api._route_costs(expand, a, b,
                                                                                    "cpu")


# ---------------------------------------------------------------------------
# B. the CUDA terms of the cost model
# ---------------------------------------------------------------------------


def _page(*nbytes):
    return sum(b for b in nbytes if b > 32 << 20) / 3e9


def _fetch_page(*nbytes):
    return sum(b for b in nbytes if b > 32 << 20) / 4e9


def _down(*arrays):
    """Each array as (bytes on the card, bytes of the host array it lands
    in): the link, the host copy and the host array's fresh pages."""
    return (sum(d for d, _ in arrays) / 2e9 + sum(h for _, h in arrays) / 6e9
            + _fetch_page(*(h for _, h in arrays)))


def _up(entries, operands, val_bytes):
    """from_scipy: three transfers per operand, the bytes, the host work."""
    return 3 * operands * 2e-3 + (4 + val_bytes) * entries / 5e9 + entries / 4e8


def _upload(a, b, val_bytes):
    return _up(a.nnz + b.nnz, 2, val_bytes)


def _to_scipy(nnz, val_bytes, fresh=None):
    """Three fetches, the link, 12 bytes an entry copied, the fresh pages
    (those past the threshold unless given), csr_matrix's rest."""
    fresh = _fetch_page(4 * nnz, 8 * nnz) if fresh is None else fresh / 4e9
    return 3 * 2e-3 + (4 + val_bytes) * nnz / 2e9 + 12 * nnz / 6e9 + fresh + nnz / 2e8


def _fresh_copy(nnz):
    """A copy of a host CSR's entries into fresh arrays: the copy and 12
    bytes an entry of fresh pages."""
    return nnz / 5e8 + 12 * nnz / 3e9


def _stitch(nnz):
    """The concatenation and the output: two copies into fresh arrays."""
    return 2 * _fresh_copy(nnz)


def _host_side(expand, nnz, copied=0):
    """spgemm_host: partials, the entries of A's one-entry rows (``copied``),
    the other entries, and the output's fresh pages."""
    return (expand / 3e9 + copied / 4e8 + max(nnz - copied, 0) / 1e8
            + _page(4 * nnz, 8 * nnz) * 3e9 / 1e9)


def _copied(a, b, symmetric=False):
    """The output entries of A's rows of one stored entry, row by row: the
    length of the B row each selects (the upper triangle's share of them
    for a symmetric output)."""
    total = 0
    for i in range(a.shape[0]):
        lo, hi = a.indptr[i], a.indptr[i + 1]
        if hi - lo == 1:
            j = a.indices[lo]
            total += int(b.indptr[j + 1] - b.indptr[j])
    m = a.shape[0]
    return total * (m + 1) // (2 * m) if symmetric else total


# (request, operands (m, k, n, da, db), symmetric, expansion, ESC budget,
# Config keywords): each branch of _cuda_route_costs once, results past the
# 32 MiB mmap threshold, and the chunked routes at one chunk and at several.
SPARSE_CASES = [
    ("esc", (3000, 3000, 3000, 0.001, 0.001), False, 30_000, None, {}),
    ("esc", (300_000, 3000, 300_000, 1e-4, 1e-4), False, 20_000_000, None, {}),  # fresh pages
    ("esc_chunks", (3000, 3000, 3000, 0.001, 0.001), True, 30_000, None, {}),
    ("esc_chunks", (300_000, 3000, 300_000, 1e-4, 1e-4), False, 20_000_000, 3_000_000,
     {}),  # 7 chunks, a result past the threshold
    ("dense", (1500, 1500, 1500, 0.01, 0.01), False, 1_500_000, None, {}),  # a small panel
    ("dense", (2500, 2500, 2500, 0.1, 0.1), True, 10**10, None, {}),  # a full triangle
    ("dense", (5000, 5000, 5000, 0.1, 0.1), True, 10**11, None, {}),  # a full triangle, fresh pages
    ("dense", (2500, 2500, 2500, 0.1, 0.1), False, 10**10, None, {}),  # the panel downloads
    ("dense", (2500, 2500, 2500, 0.01, 0.01), False, 6_000_000, None, {}),  # packed CSR downloads
    ("dense_chunks", (2500, 2500, 2500, 0.01, 0.01), True, 6_000_000, None, {}),
    ("dense_chunks", (2500, 2500, 2500, 0.002, 0.002), False, 1_000_000, None,
     dict(dense_path_limit=1_000_000)),  # 7 chunks of 400 rows, packed CSR downloads
]


def _esc_device_side(request, a, b, nnz, expand, val, limit):
    """The ESC routes' device side, stage by stage as the router runs them."""
    plan = a.nnz / 1.5e8
    if request == "esc":
        return _upload(a, b, val) + plan + 2e-3 + expand / 2e9 + _to_scipy(nnz, val)
    chunks = math.ceil(expand / (limit or tsmm.get_config().esc_expand_limit))
    part = nnz / chunks
    return (_up(b.nnz, 1, val) + plan
            + 2 * a.nnz / 1.2e8 + _up(a.nnz, chunks, val)  # A's slices, their checks, uploads
            + chunks * 2e-3 + expand / 2e9
            + chunks * _to_scipy(part, val) + nnz / 1.2e8 + 12 * nnz / 3e9  # slices, held parts
            + _stitch(nnz))


@pytest.mark.parametrize("request_kind,shape,symmetric,expand,limit,cfg", SPARSE_CASES,
                         ids=[f"{c[0]}_{i}" for i, c in enumerate(SPARSE_CASES)])
def test_cuda_sparse_costs_are_the_formula(config, request_kind, shape, symmetric, expand, limit,
                                           cfg):
    config(**cfg)
    a, b = _operands(*shape)
    m, n = a.shape[0], b.shape[1]
    val = api._value_bytes(a, b, "cuda")
    full = nnz = api._est_result_nnz(expand, m, n)
    if symmetric:
        nnz = nnz * (m + 1) // (2 * m)
    est_host, est_dev = api._route_costs(expand, a, b, "cuda", request=request_kind,
                                         symmetric=symmetric, esc_limit=limit)
    assert est_host == pytest.approx(_host_side(expand, nnz, _copied(a, b, symmetric)),
                                     rel=1e-12)
    if request_kind.startswith("esc"):
        want = _esc_device_side(request_kind, a, b, nnz, expand, val, limit)
        assert est_dev == pytest.approx(want, rel=1e-12)
        return
    chunks, upload = 1, _upload(a, b, val)
    if request_kind == "dense_chunks":  # row chunks of the full product, B uploaded by each
        chunks = math.ceil(m / min(m, tsmm.get_config().dense_path_limit // n))
        upload = _up(a.nnz + chunks * b.nnz, 2 * chunks, val) + 2 * a.nnz / 1.2e8
        nnz = full
    held = request_kind == "dense_chunks"
    if m * n <= tsmm.get_config().host_extract_limit:
        want = _down((val * m * n, 8 * m * n)) + m * n / 5e7
    elif symmetric and request_kind == "dense" and m * n * math.exp(-expand / (m * n)) < 1:
        want = _down((val * nnz, 8 * nnz)) + nnz / 7e7
    elif val * m * n < (4 + val) * fine_capacity(nnz):
        part = val * m * n / chunks
        want = (chunks * _down((part, part)) + m * n / 5e8
                + (12 * nnz / 3e9 if held else _page(4 * nnz, 8 * nnz)))
    else:
        part = nnz / chunks
        want = chunks * _to_scipy(part, val, fresh=12 * part if held else None)
    if held:
        want += _stitch(nnz)
        if symmetric:
            want += _fresh_copy(full * (m + 1) // (2 * m))  # csr_triu
    assert est_dev == pytest.approx(upload + want, rel=1e-12)


def test_fresh_pages_past_the_mmap_threshold():
    assert api._MMAP_BYTES == 32 << 20
    assert api._fresh(32 << 20, (32 << 20) + 1, 10) == (32 << 20) + 1
    assert api._fresh() == 0


def _skewed(m, k, seed):
    """(m, k) CSR whose row lengths follow a heavy tail (1 to 200 entries)."""
    rng = np.random.default_rng(seed)
    return _rows_of(np.minimum(rng.zipf(1.6, m), 200), k, seed)


@pytest.mark.parametrize("rows", ["uniform", "skewed"])
@pytest.mark.parametrize("budget", [0.07, 0.13, 0.31])
def test_priced_chunk_count_is_the_cut(rows, budget):
    """ceil(expand / budget), the chunks the cost model prices, is within one
    of the chunks _flop_chunk_bounds cuts, on uniform and heavy-tailed rows
    of A (each row far under the budget)."""
    if rows == "uniform":
        a, b = hypersparse_random(6000, 5000, 30_000, 3), hypersparse_random(5000, 5000, 60_000, 4)
    else:
        a, b = _skewed(3000, 5000, 5), hypersparse_random(5000, 5000, 60_000, 6)
    flops = api.row_flops(a.indptr, a.indices, b.indptr)
    expand = int(flops.sum())
    limit = int(budget * expand)
    assert flops.max() < 0.1 * limit
    cut = len(api._flop_chunk_bounds(flops, limit, a.shape[0])) - 1
    priced = api._esc_chunk_count(expand, limit)
    assert cut > 2 and abs(priced - cut) <= 1


def test_stitch_prices_both_copies_and_their_fresh_pages(config, monkeypatch):
    """stitch_csr's price is two copies of the entries, each into fresh
    pages (12 bytes an entry), at any size; both chunked routes price their
    stitch with it, on every entry of the parts they stitch."""
    nnz = 1_000
    assert api._stitch_cost(nnz, tsmm.get_config()) == pytest.approx(
        2 * nnz / 5e8 + 2 * 12 * nnz / 3e9, rel=1e-12)
    config(stitch_copy_rate=1e300)
    assert api._stitch_cost(nnz, tsmm.get_config()) == pytest.approx(2 * 12 * nnz / 3e9, rel=1e-12)
    config(stitch_copy_rate=5e8, host_page_rate=1e300)
    assert api._stitch_cost(nnz, tsmm.get_config()) == pytest.approx(2 * nnz / 5e8, rel=1e-12)
    config(host_page_rate=3e9)
    stitched = []
    real = api._stitch_cost
    monkeypatch.setattr(api, "_stitch_cost", lambda n, cfg: stitched.append(n) or real(n, cfg))
    a, b = _operands(2500, 2500, 2500, 0.002, 0.002)
    full = api._est_result_nnz(1_000_000, 2500, 2500)
    for request in ("esc_chunks", "dense_chunks", "esc", "dense"):
        api._route_costs(1_000_000, a, b, "cuda", request=request, symmetric=True,
                         esc_limit=300_000)
    # esc_chunks stitches the triangle's parts; dense_chunks the full product's, then cuts it
    assert stitched == [full * 2501 // 5000, full]


def test_stage_costs_sum_to_the_device_side(config):
    """_request_stage_costs gives an ESC route's device side by the stages
    the router times, summing to the model's est_dev; no stages on the
    other routes."""
    a, b = _hyper(20_000, 60_000)
    for kw, stages in ((dict(), {"windowed_plan", "upload", "engine", "download"}),
                       (dict(imem_size=1), {"upload_b", "windowed_plan", "chunk_upload", "engine",
                                            "download", "stitch"})):
        if kw:
            expand = int(api.expansion_size(a.indices, a.nnz, b.indptr))
            config(use_binned_esc=False, dense_path_limit=1000, esc_expand_limit=expand // 2)
        priced = api._request_stage_costs(a, b, "cuda", **kw)
        assert set(priced) == stages
        assert sum(priced.values()) == pytest.approx(api._request_costs(a, b, "cuda", **kw)[1],
                                                     rel=1e-12)
    config(esc_expand_limit=1 << 22, dense_path_limit=1 << 28)
    assert api._request_stage_costs(*_operands(400, 400, 400, 0.05, 0.05), "cuda") == {}


# The ESC route's link and engine made free, so that only the host work of the
# chunks' downloads and of the stitch is left on the device side.
FREE_LINK_AND_ENGINE = dict(link_fixed_s=1e-12, link_up_bytes_per_s=1e300,
                            link_down_bytes_per_s=1e300, host_upload_rate=1e300,
                            esc_plan_rate=1e300, esc_fixed_s=1e-12, esc_engine_rate=1e300)
FREE_DOWNLOADS = dict(host_copy_rate=1e300, host_page_rate=1e300, host_fetch_page_rate=1e300,
                      host_csr_rate=1e300, host_slice_rate=1e300, stitch_copy_rate=1e300)


@pytest.mark.parametrize("side", ["host", "device"])
def test_chunked_request_follows_its_stitch_and_downloads(config, on_cuda, side):
    """A request on the flop-balanced chunks: priced at MODEL's rates for its
    chunks' downloads and its stitch, spgemm_host wins; with those free, the
    device route does.  Either way scipy's answer."""
    a, b = _hyper()
    expand = int(api.expansion_size(a.indices, a.nnz, b.indptr))
    config(host_compute_limit=0, use_binned_esc=False, dense_path_limit=1000,
           esc_expand_limit=expand // 4, **FREE_LINK_AND_ENGINE,
           **(FREE_DOWNLOADS if side == "device" else {}))
    assert api._sparse_device_route(expand, a, b, api._esc_limit(None), "cuda") == "esc_chunks"
    est_host, est_dev = api._request_costs(a, b, "cuda")
    assert (est_host < est_dev) == (side == "host")
    got = tsmm.sparse_matrix_multiply(a, b, device="cuda")
    assert tsmm.get_last_route() == ("host" if side == "host" else "esc_chunks")
    if side == "device":
        assert abs(api.get_last_route_detail()["chunks"]
                   - api._esc_chunk_count(expand, api._esc_limit(None))) <= 1
    ref = (a @ b).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, **ORACLE)


@pytest.mark.parametrize("full", [0, 1])
def test_cuda_triple_and_dense_output_costs_are_the_formula(config, full):
    h, q = _operands(800, 600, 600, 0.01, 0.02)
    m, k = h.shape
    val = api._value_bytes(h, q, "cuda")
    expand = 2 * 9000  # JAX's: twice the expansion of H Q
    hq = api._est_result_nnz(9000, m, k)
    est_host, est_dev = api._route_costs(expand, h, q, "cuda", out_bytes=val * m * m,
                                         request="triple", full=bool(full))
    partials = 9000 + hq * h.nnz / k
    assert est_host == pytest.approx(partials / 1.5e8 + (4 if full else 2) * m * m / 3e8,
                                     rel=1e-12)
    assert est_dev == pytest.approx(_upload(h, q, val) + _down((val * m * m, 8 * m * m)),
                                    rel=1e-12)
    a, b = _operands(700, 500, 900, 0.01, 0.02, seed=4)
    m, n = a.shape[0], b.shape[1]
    val = api._value_bytes(a, b, "cuda")
    nnz = api._est_result_nnz(50_000, m, n)
    est_host, est_dev = api._route_costs(50_000, a, b, "cuda", out_bytes=val * m * n,
                                         request="dense_output")
    assert est_host == pytest.approx(_host_side(50_000, nnz, _copied(a, b)) + m * n / 3e8,
                                     rel=1e-12)
    assert est_dev == pytest.approx(_upload(a, b, val) + _down((val * m * n, 8 * m * n)),
                                    rel=1e-12)
    # A symmetric square output: toarray touches the triangle's half of the pages.
    a, b = _operands(900, 500, 900, 0.01, 0.02, seed=5)
    m = n = 900
    nnz = api._est_result_nnz(50_000, m, n) * (m + 1) // (2 * m)
    est_host, est_dev = api._route_costs(50_000, a, b, "cuda", out_bytes=val * m * n,
                                         request="dense_output", symmetric=True)
    assert est_host == pytest.approx(
        _host_side(50_000, nnz, _copied(a, b, symmetric=True)) + 0.5 * m * n / 3e8, rel=1e-12)
    assert est_dev == pytest.approx(_upload(a, b, val) + _down((val * m * n, 8 * m * n)),
                                    rel=1e-12)


def _one_per_row(m, k, seed):
    rng = np.random.default_rng(seed)
    return sp.csr_matrix((rng.uniform(size=m), rng.integers(0, k, m), np.arange(m + 1)),
                         shape=(m, k))


def _rows_of(lengths, k, seed):
    """A CSR matrix whose rows hold ``lengths`` entries in distinct random columns."""
    rng = np.random.default_rng(seed)
    cols = [np.sort(rng.choice(k, size=n, replace=False)) for n in lengths]
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    return sp.csr_matrix((rng.uniform(size=indptr[-1]), np.concatenate(cols), indptr),
                         shape=(len(lengths), k))


def _copy_operands(kind, seed=0):
    """(A, B) with A 1500 x 1000 and B 1000 x 1500: A of one entry per row,
    rows of 0, 1, 2 or 5 entries, or sp.random's rows of ~3 (B's rows of
    0 to 15)."""
    rng = np.random.default_rng(seed + 50)
    b = _rows_of(rng.integers(0, 16, 1000), 1500, seed + 1)
    if kind == "one_per_row":
        return _one_per_row(1500, 1000, seed), b
    if kind == "mixed":
        return _rows_of(rng.choice([0, 1, 1, 2, 5], 1500), 1000, seed), b
    return sp.random(1500, 1000, density=0.003, format="csr", random_state=seed), b


@pytest.mark.parametrize("kind,want", [("one_per_row", "all"), ("mixed", "some"),
                                       ("random", "some"), ("empty_rows", "none")])
def test_single_row_entries_is_a_loop_over_the_rows(kind, want):
    if kind == "empty_rows":
        a, b = _rows_of([0, 2, 0, 3] * 100, 1000, 3), _copy_operands("mixed")[1]
    else:
        a, b = _copy_operands(kind)
    got = api._single_row_entries(a, b)
    assert isinstance(got, int) and got == _copied(a, b)
    expand = int(api.expansion_size(a.indices, a.nnz, b.indptr))
    assert {"all": got == expand, "some": 0 < got < expand, "none": got == 0}[want]


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("kind", ["one_per_row", "mixed", "random"])
def test_copy_term_is_the_formula(config, kind, symmetric):
    """spgemm_host's entries split by A's row lengths on CUDA: those of the
    one-entry rows at host_copy_entry_rate, the rest at host_entry_rate;
    the CPU's price (JAX's) has no such term."""
    a, b = _copy_operands(kind, seed=7)
    m, n = a.shape[0], b.shape[1]
    expand = int(api.expansion_size(a.indices, a.nnz, b.indptr))
    nnz = api._est_result_nnz(expand, m, n)
    if symmetric:
        nnz = nnz * (m + 1) // (2 * m)
    copied = _copied(a, b, symmetric)
    est_host, _ = api._route_costs(expand, a, b, "cuda", request="esc", symmetric=symmetric)
    assert est_host == pytest.approx(_host_side(expand, nnz, copied), rel=1e-12)
    cpu = api._route_costs(expand, a, b, "cpu", request="esc", symmetric=symmetric)
    config(host_copy_entry_rate=1.0)
    assert api._route_costs(expand, a, b, "cpu", request="esc", symmetric=symmetric) == cpu
    slower = api._route_costs(expand, a, b, "cuda", request="esc", symmetric=symmetric)[0]
    assert slower - est_host == pytest.approx(copied - copied / 4e8, rel=1e-9)


@pytest.mark.parametrize("side", ["host", "device"])
def test_one_per_row_request_follows_the_copy_rate(config, on_cuda, side):
    """A small request of one entry per row of A: to the host with the copy
    rate set above its crossover, to the device below it; either way
    scipy's answer."""
    config(host_compute_limit=0)
    a = _one_per_row(4000, 5000, 11)
    b = hypersparse_random(5000, 5000, 100_000, 12)
    expand = int(api.expansion_size(a.indices, a.nnz, b.indptr))
    route = api._sparse_device_route(expand, a, b, api._esc_limit(None), "cuda")
    assert route == "esc"
    copied = api._single_row_entries(a, b)
    assert copied == expand
    _, est_dev = api._route_costs(expand, a, b, "cuda", request=route)
    rest = max(api._est_result_nnz(expand, 4000, 5000) - copied, 0)
    crossover = copied / (est_dev - expand / 3e9 - rest / 1e8)
    assert crossover > 0
    config(host_copy_entry_rate=crossover * (2.0 if side == "host" else 0.5))
    got = tsmm.sparse_matrix_multiply(a, b, device="cuda")
    assert (tsmm.get_last_route() == "host") == (side == "host")
    ref = (a @ b).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, **ORACLE)


@pytest.mark.parametrize("request_kind", ["esc", "dense", "dense_chunks", "esc_chunks",
                                          "dense_output", "triple"])
def test_cpu_costs_stay_jax_whatever_the_request(config, request_kind):
    """On the CPU a named device route changes nothing: JAX's formula, and
    JAX's decision on both sides of the flip."""
    a, b = _operands(2000, 500, 3000, 0.001, 0.02)
    out_bytes = 8 * a.shape[0] * b.shape[1] if request_kind in ("dense_output", "triple") else None
    decisions = set()
    for expand in np.unique(np.geomspace(1e3, 1e10, 30).astype(np.int64)):
        plain = api._route_costs(int(expand), a, b, "cpu", out_bytes)
        named = api._route_costs(int(expand), a, b, "cpu", out_bytes, request=request_kind,
                                 symmetric=True, full=True)
        assert named == plain
        wins = api._host_route_wins(int(expand), a, b, "cpu", out_bytes, request=request_kind)
        assert wins == japi._host_route_wins(int(expand), a, b, out_bytes=out_bytes)
        decisions.add(wins)
    assert decisions == {True, False}


def test_request_costs_name_the_route_the_router_takes(config, on_cuda, monkeypatch):
    """_request_costs prices each branch with the device route the router
    then takes on CUDA."""
    seen = []
    real = api._route_costs

    def spy(*args, **kw):
        seen.append(kw.get("request"))
        return real(*args, **kw)

    monkeypatch.setattr(api, "_route_costs", spy)
    # every request stays on the device
    config(host_compute_limit=0, host_partial_rate=1.0, scipy_partial_rate=1.0)
    hyper = _hyper()
    for (a, b), kw, route in ((_operands(400, 400, 400, 0.05, 0.05), {}, "dense"),
                              (hyper, {}, "esc_windowed"),
                              (hyper, dict(output_format="dense"), "dense"),
                              (_operands(300, 200, 200, 0.05, 0.05),
                               dict(use_triple_product=True), "triple")):
        seen.clear()
        api._request_costs(a, b, "cuda", **kw)
        tsmm.sparse_matrix_multiply(a, b, device="cuda", **kw)
        assert tsmm.get_last_route() == route
        assert len(seen) == 2 and seen[0] == seen[1]


# ---------------------------------------------------------------------------
# C. the ladder on CUDA: the windowed rung, with the binned rung's budget
# ---------------------------------------------------------------------------


@pytest.fixture
def binned_plans(monkeypatch):
    """The calls of _binned_plan_for; on CUDA it must not be called."""
    calls = []
    real = api._binned_plan_for

    def spy(a_sp, b_sp, expand):
        calls.append(expand)
        return real(a_sp, b_sp, expand)

    monkeypatch.setattr(api, "_binned_plan_for", spy)
    return calls


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("device,route", [("cpu", "esc_binned"), ("cuda", "esc_windowed")])
def test_ladder_skips_the_binned_rung_on_cuda(config, on_cuda, binned_plans, device, route,
                                              symmetric):
    config(host_compute_limit=0, host_rate_base=1.0, host_partial_rate=1.0)
    a, b = _hyper()
    got = tsmm.sparse_matrix_multiply(a, b, symmetric=symmetric, device=device)
    assert tsmm.get_last_route() == route
    assert (binned_plans != []) == (device == "cpu")
    ref = a @ b
    ref = sp.triu(ref, format="csr") if symmetric else ref.tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, **ORACLE)


def test_binned_rung_stays_reachable_on_cuda(config, on_cuda, binned_plans):
    config(host_compute_limit=0, host_partial_rate=1.0, binned_esc_on_cuda=True)
    a, b = _hyper()
    got = tsmm.sparse_matrix_multiply(a, b, device="cuda")
    assert tsmm.get_last_route() == "esc_binned" and len(binned_plans) == 1
    np.testing.assert_allclose(got.toarray(), (a @ b).toarray(), **ORACLE)


def test_windowed_rung_takes_the_binned_budget_on_cuda(config, on_cuda, binned_plans):
    """Between the ESC budget and the binned one: the binned rung on the CPU,
    the windowed one on CUDA (one dispatch); past the binned budget, the row
    chunks on both."""
    a, b = _hyper()
    expand = int(api.expansion_size(a.indices, a.nnz, b.indptr))
    config(host_compute_limit=0, host_rate_base=1.0, host_partial_rate=1.0, dense_path_limit=1000,
           esc_expand_limit=expand // 4, binned_expand_limit=expand * 2)
    for device, route in (("cpu", "esc_binned"), ("cuda", "esc_windowed")):
        tsmm.sparse_matrix_multiply(a, b, device=device)
        assert tsmm.get_last_route() == route
    config(binned_expand_limit=expand // 2)
    for device in ("cpu", "cuda"):
        got = tsmm.sparse_matrix_multiply(a, b, device=device)
        assert tsmm.get_last_route() == "esc_chunks"
        np.testing.assert_allclose(got.toarray(), (a @ b).toarray(), **ORACLE)


def test_classic_engine_keeps_the_esc_budget_on_cuda(config, on_cuda, binned_plans):
    """No window qualifies (B's rows are long): within the ESC budget the
    classic engine, past it the row chunks, as the binned rung's failure
    sends the CPU there."""
    a = sp.csr_matrix((np.ones(300), (np.arange(300), np.arange(300) % 40)), shape=(300, 40))
    b = sp.random(40, 3000, density=0.2, format="csr", random_state=3)
    expand = int(api.expansion_size(a.indices, a.nnz, b.indptr))
    assert api.windowed_plan(a.nnz, np.diff(b.indptr)[a.indices], expand) is None
    config(host_compute_limit=0, host_partial_rate=1.0, dense_path_limit=1000)
    tsmm.sparse_matrix_multiply(a, b, device="cuda")
    assert tsmm.get_last_route() == "esc"
    config(esc_expand_limit=expand // 2, binned_expand_limit=expand * 4)
    got = tsmm.sparse_matrix_multiply(a, b, device="cuda")
    assert tsmm.get_last_route() == "esc_chunks" and binned_plans == []
    np.testing.assert_allclose(got.toarray(), (a @ b).toarray(), **ORACLE)


# ---------------------------------------------------------------------------
# D. the BSR cutoff and the occupancy scan
# ---------------------------------------------------------------------------


class ShapeOnly:
    """A matrix that has a shape and nothing to scan."""

    shape = (1024, 1024)


def test_cutoff_zero_scans_nothing(config):
    assert tsmm.get_config().cuda_bsr_occupancy_cutoff == 0.0
    assert not api._bsr_route_ok(ShapeOnly(), "cuda")
    assert not api._block_sparse(ShapeOnly(), 128, 0.0)
    config(cuda_bsr_occupancy_cutoff=0.25)
    with pytest.raises(ValueError):
        api._bsr_route_ok(ShapeOnly(), "cuda")  # above 0 the scan reads the matrix


@pytest.fixture
def scans(monkeypatch):
    """The occupancy questions the router asks: (shape, cutoff)."""
    calls = []
    real = api._block_sparse

    def spy(mat, block_size, cutoff):
        calls.append((mat.shape, cutoff))
        return real(mat, block_size, cutoff)

    monkeypatch.setattr(api, "_block_sparse", spy)
    return calls


@pytest.mark.parametrize("output_format", ["sparse", "dense"])
def test_dense_route_on_cuda_scans_nothing(config, on_cuda, scans, output_format):
    """A uniformly sparse request (the headline's kind) on CUDA: the dense
    route, and no occupancy scan at the cutoff of 0."""
    config(host_compute_limit=0, host_partial_rate=1.0, host_rate_base=1.0)
    a, b = _operands(600, 600, 600, 0.3, 0.3, seed=7)
    got = tsmm.sparse_matrix_multiply(a, b, output_format, symmetric=True, device="cuda")
    assert tsmm.get_last_route() == "dense"
    assert all(cutoff == 0.0 for _, cutoff in scans)
    got = got.toarray() if sp.issparse(got) else got
    np.testing.assert_allclose(got, np.triu((a @ b).toarray()), **ORACLE)


def _occupancy_cases():
    rng = np.random.default_rng(5)
    for nbr, nbc, occ in ((8, 8, 0.1), (20, 5, 0.3), (17, 33, 0.05), (40, 40, 0.5), (3, 3, 1.0)):
        mask = rng.random((nbr, nbc)) < occ
        dense = np.kron(mask, np.ones((4, 4))) * rng.random((4 * nbr, 4 * nbc))
        yield sp.csr_matrix(dense[: 4 * nbr - 1])  # a ragged last block-row
    yield sp.random(300, 200, density=0.01, format="csr", random_state=3)
    yield sp.csr_matrix((64, 64))


@pytest.mark.parametrize("case", range(7))
def test_early_stop_gives_the_full_scans_answer(case):
    mat = list(_occupancy_cases())[case]
    occ = api.block_occupancy(mat, 4)
    for cutoff in sorted({0.01, 0.05, 0.1, 0.25, 0.5, 0.99, occ, min(occ + 1e-9, 1.0)}):
        if cutoff > 0:
            assert api._block_sparse(mat, 4, cutoff) == (occ <= cutoff), (case, cutoff)
            assert api._block_sparse(mat.tocoo(), 4, cutoff) == (occ <= cutoff)


def test_scan_stops_once_past_the_cutoff(monkeypatch):
    """Every block occupied (16 of 256 a block-row): the scan stops in the
    group that passes the cutoff, the 5th of 16 at 0.25 and the 1st at 0.05."""
    groups = []
    real = np.bincount
    monkeypatch.setattr(api.np, "bincount", lambda *a, **kw: groups.append(1) or real(*a, **kw))
    full = sp.csr_matrix(np.ones((64, 64)))
    for cutoff, read in ((0.25, 5), (0.05, 1)):
        groups.clear()
        assert not api._block_sparse(full, 4, cutoff)
        assert len(groups) == read
    groups.clear()
    assert api._block_sparse(sp.csr_matrix(np.eye(64)), 4, 0.25)  # a diagonal: 16 of 256 blocks
    assert len(groups) == 16


# ---------------------------------------------------------------------------
# E. the sweep's verdict on a pick (chip_smoke.py phase 20)
# ---------------------------------------------------------------------------


# (pick, host seconds by round, device seconds by round, right, unsteady)
VERDICTS = [
    ("host", [1.0, 1.1, 1.0], [2.0, 2.1, 1.9], True, False),
    ("device", [1.0, 1.1, 1.0], [2.0, 2.1, 1.9], False, False),  # steadily slower
    ("device", [1.0, 1.9, 1.8], [1.2, 1.2, 1.2], False, True),  # rounds straddle 1.15
    ("host", [1.1, 1.0, 1.05], [1.0, 0.95, 1.0], True, False),  # a tie within the margin
    ("host", [2.0], [1.0], False, False),  # one round (a slow warm call)
]


@pytest.mark.parametrize("pick,host,device,right,unsteady", VERDICTS)
def test_sweep_verdict_tells_a_tie_from_a_fault(pick, host, device, right, unsteady):
    verdict = chip_smoke.pick_verdict(pick, host, device)
    assert chip_smoke.PICK_MARGIN == 1.15
    assert (verdict["right"], verdict["unsteady"]) == (right, unsteady)
    assert verdict["ratios"] == pytest.approx([h / d for h, d in zip(host, device)])
