"""The CSR kernels' plain versions (K5, K6, K7), the device CSR container,
the linker's sparse bridge and the device default, on the CPU.

K5/K6 (``csr_matmul_plain``) and K7 (``csr_sddmm_plain``) are held against
SciPy and against the JAX package's Pallas kernels ``bss_matmul``,
``_bss_matmul_wide`` and ``bss_sddmm`` in interpret mode, as
``tests/sparse/test_bss.py`` and ``tests/link/test_pallas.py`` run them.
K6's split by entries is checked here through its plan
(``merge_path_plan``) and a model of its chunked sum with the fix-up of
cut rows, held against SciPy; K7's split of x's entries by the same plan
through a model of how its lane groups take them.
Tolerance 1e-5 absolute and relative in float32 (sums of a few products
in another order), 1e-12 in float64 (SciPy only: the BSS layout stores
float32).  A stored zero against an inf in the rhs is held against SciPy
(nan), not against BSS, which masks stored zeros (``ROADMAP.md`` Queue 3).
"""

import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from aesara_tpu.link.jax.bss import _bss_matmul_wide, bss_matmul, bss_sddmm, csr_to_bss

import aesara_tpu_torch as ptp
import aesara_tpu_torch.tensor as pt
from aesara_tpu_torch import sparse
from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.torch.csr import CSRMat
from aesara_tpu_torch.link.torch.kernels.sparse import (
    SPMM_CHUNK, csr_matmul, csr_matmul_plain, csr_sddmm, csr_sddmm_plain, csr_spmm, csr_spmv,
    merge_path_plan, row_ids, spmm_plan, spmm_vector_bytes,
)
from aesara_tpu_torch.sparse.basic import StructuredDotGradA


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


F32 = dict(atol=1e-5, rtol=1e-5)
F64 = dict(atol=1e-12, rtol=1e-12)
CPU = torch.device("cpu")


def _rand_csr(n, d, density, seed=0, dtype=np.float32):
    return sps.random(n, d, density=density, format="csr", dtype=dtype,
                      random_state=np.random.RandomState(seed))


def _with_empty_rows(n=300, d=200, seed=1):
    x = _rand_csr(n, d, 0.05, seed).tolil()
    x[::7] = 0                       # every 7th row stores nothing
    x = x.tocsr()
    x.eliminate_zeros()
    assert (np.diff(x.indptr)[::7] == 0).all()
    return x


def _with_duplicates(n=200, d=150, seed=2):
    """A CSR whose rows hold duplicate and unsorted column indices."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, size=n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = rng.integers(0, d, size=indptr[-1])     # repeats within rows, unsorted
    data = rng.normal(size=indptr[-1]).astype("float32")
    x = sps.csr_matrix((data, indices, indptr), shape=(n, d))
    assert not x.has_canonical_format
    return x


def _rhs(d, C, seed=3, dtype="float32"):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(d,) if C is None else (d, C)).astype(dtype)


MATRICES = {"random": lambda: _rand_csr(300, 200, 0.03), "empty_rows": _with_empty_rows,
            "duplicates": _with_duplicates}


@pytest.mark.parametrize("C", [None, 1, 8, 9, 20], ids=["vector", "C1", "C8", "C9", "C20"])
@pytest.mark.parametrize("which", sorted(MATRICES))
def test_plain_k5_k6_match_scipy_and_pallas_interpret(which, C):
    x = MATRICES[which]()
    b = _rhs(x.shape[1], C)
    a = CSRMat.from_scipy(x, CPU)
    got = csr_matmul_plain(a, torch.from_numpy(b), torch.float32).numpy()
    np.testing.assert_allclose(got, x @ b, **F32)
    bss = csr_to_bss(x)
    with pltpu.force_tpu_interpret_mode():
        if C is not None and C > 8:
            want = _bss_matmul_wide(bss, jnp.asarray(b))     # K6's TPU kernel
        else:
            want = bss_matmul(bss, jnp.asarray(b))           # K5's TPU kernel
    np.testing.assert_allclose(got, np.asarray(want), **F32)


@pytest.mark.parametrize("C", [None, 8, 20], ids=["vector", "C8", "C20"])
def test_plain_k5_k6_float64_match_scipy(C):
    x = _with_duplicates().astype("float64")
    b = _rhs(x.shape[1], C, dtype="float64")
    a = CSRMat.from_scipy(x, CPU)
    assert a.data.dtype == torch.float64
    got = csr_matmul_plain(a, torch.from_numpy(b), torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), x @ b, **F64)


def test_a_stored_zero_times_inf_is_nan_as_in_scipy():
    # row 0 stores an explicit 0 at column 2; row 1 stores nothing there
    x = sps.csr_matrix((np.array([0.0, 1.0, 2.0], "float32"), np.array([2, 0, 1]),
                        np.array([0, 2, 3])), shape=(2, 3))
    b = np.array([[1.0], [2.0], [np.inf]], "float32")
    want = x @ b
    assert np.isnan(want[0, 0]) and want[1, 0] == 4.0
    got = csr_matmul_plain(CSRMat.from_scipy(x, CPU), torch.from_numpy(b), torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_the_wrappers_take_the_plain_versions_for_cpu_tensors():
    x = _rand_csr(50, 40, 0.1)
    a = CSRMat.from_scipy(x, CPU)
    b = torch.from_numpy(_rhs(40, 3))
    counts = (csr_spmv.plain_calls, csr_spmm.plain_calls, csr_sddmm.plain_calls)
    for fn in (csr_spmv, csr_spmm):
        np.testing.assert_allclose(fn(a, b).numpy(), x @ b.numpy(), **F32)
    csr_matmul(a, b, torch.float32)                   # 3 columns: K5
    gz = torch.from_numpy(_rhs(50, 3, seed=4))
    assert csr_sddmm(a, gz, b).shape == x.shape
    assert (csr_spmv.plain_calls, csr_spmm.plain_calls, csr_sddmm.plain_calls) == (
        counts[0] + 2, counts[1] + 1, counts[2] + 1)
    assert csr_spmv.launches == csr_spmm.launches == csr_sddmm.launches == 0


def _sddmm_oracle(x, gz, b):
    """StructuredDotGradA's SciPy perform."""
    fake = type("node", (), {"outputs": [sparse.csr_matrix(dtype=x.dtype.name)]})
    out = [[None]]
    StructuredDotGradA().perform(fake, [gz, b, x], out)
    return out[0][0]


@pytest.mark.parametrize("C", [None, 1, 8, 20], ids=["vector", "C1", "C8", "C20"])
def test_plain_k7_matches_scipy_and_pallas_interpret(C):
    x = _rand_csr(256, 300, 0.02, seed=5)        # n a multiple of 128: BSS pads no rows
    gz, b = _rhs(256, C, seed=6), _rhs(300, C, seed=7)
    a = CSRMat.from_scipy(x, CPU)
    got = a.with_data(csr_sddmm_plain(a, torch.from_numpy(gz), torch.from_numpy(b))).to_scipy()
    want = _sddmm_oracle(x, gz, b)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, **F32)
    with pltpu.force_tpu_interpret_mode():
        sampled = bss_sddmm(csr_to_bss(x), jnp.asarray(gz), jnp.asarray(b))
    np.testing.assert_allclose(got.toarray(), np.asarray(sampled.todense()), **F32)


@pytest.mark.parametrize("which", ["empty_rows", "duplicates"])
def test_plain_k7_keeps_the_canonical_pattern(which):
    x = MATRICES[which]()
    canonical = x.copy()
    canonical.sum_duplicates()
    gz, b = _rhs(x.shape[0], 4, seed=8), _rhs(x.shape[1], 4, seed=9)
    a = CSRMat.from_scipy(x, CPU)
    got = a.with_data(csr_sddmm_plain(a, torch.from_numpy(gz), torch.from_numpy(b))).to_scipy()
    want = _sddmm_oracle(canonical, gz, b)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, **F32)
    f64 = CSRMat.from_scipy(x.astype("float64"), CPU)
    got64 = csr_sddmm_plain(f64, torch.from_numpy(gz.astype("float64")),
                            torch.from_numpy(b.astype("float64")))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), _sddmm_oracle(canonical.astype("float64"),
                                                            gz.astype("float64"),
                                                            b.astype("float64")).data, **F64)


def test_csrmat_sums_duplicates_keeps_stored_zeros_and_links_its_twin():
    x = _with_duplicates()
    x.data[:3] = 0.0
    a = CSRMat.from_scipy(x, CPU, with_transpose=True)
    assert a.indptr.dtype == a.indices.dtype == torch.int32 and a.data.dtype == torch.float32
    canonical = x.copy()
    canonical.sum_duplicates()
    back = a.to_scipy()
    assert back.nnz == canonical.nnz           # stored zeros stay stored
    np.testing.assert_array_equal(back.toarray(), x.toarray())
    t = a.transpose()
    assert t.shape == (x.shape[1], x.shape[0])
    np.testing.assert_array_equal(t.to_scipy().toarray(), x.toarray().T)
    np.testing.assert_array_equal(t.transpose().to_scipy().toarray(), x.toarray())
    assert not x.has_canonical_format          # the caller's matrix is left as it was
    with pytest.raises(ValueError, match="twin"):
        CSRMat.from_scipy(x, CPU).transpose()


def test_shared_sparse_value_is_a_scipy_copy_and_set_value_reaches_the_device():
    x0, x1 = _rand_csr(30, 20, 0.2, seed=10), _rand_csr(30, 20, 0.2, seed=11)
    xs = ptp.shared(x0, name="x")
    assert isinstance(xs, sparse.SparseTensorSharedVariable) and xs.type.format == "csr"
    got = xs.get_value()
    assert sps.issparse(got) and got is not xs.get_value()
    got.data[:] = 0                              # a copy: the variable keeps its value
    assert xs.get_value().nnz == x0.nnz and abs(xs.get_value() - x0).nnz == 0
    w = pt.matrix("w")
    f = ptp.function([w], sparse.structured_dot(xs, w))
    wv = _rhs(20, 3, seed=12)
    np.testing.assert_allclose(f(wv).numpy(), x0 @ wv, **F32)
    xs.set_value(x1)
    np.testing.assert_allclose(f(wv).numpy(), x1 @ wv, **F32)


def test_sparse_output_has_the_input_pattern_and_format():
    x = sparse.csr_matrix("x")
    gz, b = pt.matrix("gz"), pt.matrix("b")
    f = ptp.function([gz, b, x], [StructuredDotGradA()(gz, b, x), sparse.transpose(x)])
    xv = _rand_csr(40, 30, 0.1, seed=13)
    gv, bv = _rhs(40, 5, seed=14), _rhs(30, 5, seed=15)
    ga, xt = f(gv, bv, xv)
    assert ga.format == "csr" and xt.format == "csc"
    np.testing.assert_array_equal(ga.indptr, xv.indptr)
    np.testing.assert_array_equal(ga.indices, xv.indices)
    np.testing.assert_allclose(ga.data, _sddmm_oracle(xv, gv, bv).data, **F32)
    np.testing.assert_array_equal(xt.toarray(), xv.toarray().T)


def test_a_sparse_operand_without_a_lowering_fails_the_compile():
    x, y = sparse.csr_matrix("x"), sparse.csr_matrix("y")
    with pytest.raises(NotImplementedError, match="Dot"):
        ptp.function([x, y], sparse.dot(x, y))
    g = pt.matrix("g")
    computed = StructuredDotGradA()(g, g, x)
    with pytest.raises(NotImplementedError, match="Transpose"):
        ptp.function([g, x], sparse.structured_dot(sparse.transpose(computed), g))


def test_the_default_device_is_the_card():
    code = "import aesara_tpu_torch as p; print(p.config.device)"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         check=True)
    assert res.stdout.strip() == "cuda"


def test_without_a_card_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with config.change_flags(device="cuda"):      # the default, which the fixture overrides
        with pytest.raises(RuntimeError, match="cuda"):
            ptp.shared(np.zeros(3))
        with pytest.raises(RuntimeError, match="cuda"):
            ptp.shared(_rand_csr(4, 3, 0.5))
        x = pt.vector("x")
        with pytest.raises(RuntimeError, match="cuda"):
            ptp.function([x], x * 2.0)


# --------------------------------------------------------------------------
# K6's merge-path plan and its chunked sum
# --------------------------------------------------------------------------

def _heavy_tailed(n=400, d=600, seed=20):
    """Row lengths log-normal: most rows short, a few hundreds long."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(np.rint(rng.lognormal(1.5, 1.4, n)).astype(int), d)
    rows = [rng.choice(d, size=c, replace=False) for c in counts]
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return sps.csr_matrix((rng.random(indptr[-1]).astype("float32"), np.concatenate(rows), indptr),
                          shape=(n, d))


def _one_heavy_row(n=200, d=12000, seed=21):
    """Row 37 holds 9,000 of the 10,000 entries.  The values are multiples
    of 1/4, so against a rhs of multiples of 1/16 every float32 sum is
    exact in any order: the long row checks the split, not the rounding."""
    rng = np.random.default_rng(seed)
    others = np.delete(np.arange(n), 37)
    counts = np.bincount(rng.choice(others, size=1000), minlength=n)
    counts[37] = 9000
    rows = [rng.choice(d, size=c, replace=False) for c in counts]
    indptr = np.concatenate([[0], np.cumsum(counts)])
    values = rng.integers(1, 5, size=indptr[-1]).astype("float32") / 4
    x = sps.csr_matrix((values, np.concatenate(rows), indptr), shape=(n, d))
    assert x.nnz == 10000 and np.diff(x.indptr)[37] == 9000
    return x


def _mostly_empty(n=500, d=80, seed=22):
    """Nine rows in ten store nothing; the others are full."""
    x = sps.lil_matrix((n, d), dtype="float32")
    rng = np.random.default_rng(seed)
    for r in range(0, n, 10):
        x[r, :] = rng.random(d) + 0.5
    return x.tocsr()


def _bag_of_words_twin(docs=300, features=3000, seed=23):
    """The transpose of a small bag-of-words CSR made as the classifier's
    synthetic 20 Newsgroups data is: log-normal document lengths, word ids
    ~ 1/rank, repeats merged, rows at unit norm."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(np.rint(rng.lognormal(4.0, 1.0, docs)), 1, 5000).astype(np.int64)
    rank = np.floor(np.exp(rng.random(lengths.sum()) * np.log(features))).astype(np.int64) - 1
    cols = rng.permutation(features)[rank]
    x = sps.csr_matrix((rng.random(lengths.sum()).astype(np.float32), (np.repeat(np.arange(docs), lengths), cols)),
                       shape=(docs, features))
    x.data /= np.repeat(np.sqrt(np.add.reduceat(x.data.astype(np.float64) ** 2, x.indptr[:-1])),
                        np.diff(x.indptr)).astype(np.float32)
    return x.T.tocsr()


PLAN_MATRICES = {
    "heavy_tailed": _heavy_tailed,
    "one_row_90pct": _one_heavy_row,
    "mostly_empty": _mostly_empty,
    "no_entries": lambda: sps.csr_matrix((300, 50), dtype="float32"),
    "below_one_chunk": lambda: _rand_csr(6, 30, 0.3, seed=24),
    "bag_of_words_twin": _bag_of_words_twin,
    "empty_rows": _with_empty_rows,
}


def _merge_starts(indptr, chunk):
    """The rows at which the chunks start, by walking the merged sequence
    one item at a time: row r's end comes once all its entries are in."""
    n, nnz = len(indptr) - 1, int(indptr[-1])
    starts, i, j = [0], 0, 0
    for pos in range(1, n + nnz + 1):
        if i < n and indptr[i + 1] <= j:
            i += 1
        else:
            j += 1
        if pos % chunk == 0 or pos == n + nnz:
            starts.append(i)
    return np.array(starts if n + nnz else [0, 0])


@pytest.mark.parametrize("chunk", [32, SPMM_CHUNK, 512])
@pytest.mark.parametrize("which", sorted(PLAN_MATRICES))
def test_spmm_plan_covers_every_row_end_and_entry_once(which, chunk):
    a = CSRMat.from_scipy(PLAN_MATRICES[which](), CPU)
    n, nnz = a.shape[0], a.nnz
    indptr = a.indptr.numpy().astype(np.int64)
    plan = merge_path_plan(a.indptr, nnz, chunk)
    assert plan.dtype == torch.int32 and plan.device == CPU
    rows = plan.numpy().astype(np.int64)
    nchunks = len(rows) - 1
    assert nchunks == max(1, -(-(n + nnz) // chunk))
    diag = np.minimum(np.arange(nchunks + 1) * chunk, n + nnz)
    entries = diag - rows
    # monotone, from (0, 0) to (n, nnz): the chunks cut the row ends and the
    # entries into consecutive ranges, so each is covered exactly once
    assert rows[0] == 0 and rows[-1] == n and entries[0] == 0 and entries[-1] == nnz
    assert (np.diff(rows) >= 0).all() and (np.diff(entries) >= 0).all()
    items = np.diff(rows) + np.diff(entries)
    assert (items <= chunk).all() and (items[:-1] == chunk).all() and items.sum() == n + nnz
    # a start (i, j) is a point of the merge path: rows before i are done
    # (their entries lie below j), row i is not (its end lies at or past j)
    inner = rows < n
    assert (indptr[rows] <= entries).all()
    assert (indptr[rows[inner] + 1] >= entries[inner]).all()
    np.testing.assert_array_equal(rows, _merge_starts(indptr, chunk))


def _chunked_spmm(a, b, chunk):
    """A model of K6 (``csrc/csr_spmm.cu``) in float32: each chunk writes
    the rows that end in it from its own entries and leaves the row cut by
    its end in the carry; the fix-up adds a cut row's carries in chunk
    order to what the chunk that ends the row wrote.  Every row must be
    written exactly once."""
    indptr, indices = a.indptr.numpy().astype(np.int64), a.indices.numpy()
    data = a.data.numpy().astype(np.float32)
    n, nnz, C = a.shape[0], a.nnz, b.shape[1]
    plan = merge_path_plan(a.indptr, nnz, chunk).numpy().astype(np.int64)
    nchunks = len(plan) - 1
    out, carry = np.full((n, C), np.nan, np.float32), np.full((nchunks, C), np.nan, np.float32)
    written = np.zeros(n, np.int64)

    def partial(lo, hi):
        return (data[lo:hi, None] * b[indices[lo:hi]]).sum(0, dtype=np.float32)

    def start(c):
        return min(c * chunk, n + nnz) - plan[c]

    for c in range(nchunks):
        i0, i1, j0, j1 = plan[c], plan[c + 1], start(c), start(c + 1)
        k = j0
        for r in range(i0, i1):
            assert k <= indptr[r + 1] <= j1
            out[r] = partial(k, indptr[r + 1])
            written[r] += 1
            k = indptr[r + 1]
        if i1 < n:
            carry[c] = partial(k, j1)
    for c in range(1, nchunks):
        r = plan[c]
        if r >= plan[c + 1] or indptr[r] >= start(c):
            continue
        first = c - 1
        while first > 0 and plan[first] == r:
            first -= 1
        s = carry[first].copy()
        for cc in range(first + 1, c):
            s += carry[cc]
        out[r] = s + out[r]
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("chunk", [32, SPMM_CHUNK, 512])
@pytest.mark.parametrize("which", sorted(PLAN_MATRICES))
def test_chunked_spmm_model_matches_plain_and_scipy(which, chunk):
    x = PLAN_MATRICES[which]()
    b = np.round(_rhs(x.shape[1], 20, seed=25) * 16) / 16
    a = CSRMat.from_scipy(x, CPU)
    got = _chunked_spmm(a, b, chunk)
    np.testing.assert_allclose(got, x @ b, **F32)
    np.testing.assert_allclose(got, csr_matmul_plain(a, torch.from_numpy(b), torch.float32).numpy(), **F32)


def test_spmm_plan_is_kept_with_the_pattern_through_transpose_and_with_data():
    a = CSRMat.from_scipy(_bag_of_words_twin().T, CPU, with_transpose=True)
    t1, t2 = a.transpose(), a.transpose()
    assert t1 is not t2
    plan = spmm_plan(t1)
    assert spmm_plan(t2) is plan                       # kept on the twin, not on the wrapper
    assert spmm_plan(a.transpose()) is plan
    assert spmm_plan(t1.transpose()) is spmm_plan(a)
    assert spmm_plan(a.with_data(a.data * 2)) is spmm_plan(a)
    assert spmm_plan(a, 64) is not spmm_plan(a) and spmm_plan(a, 64) is spmm_plan(a.transpose().transpose(), 64)
    torch.testing.assert_close(plan, merge_path_plan(a.t.indptr, a.t.nnz), rtol=0, atol=0)
    assert CSRMat.from_scipy(_rand_csr(5, 4, 0.5), CPU).plans == {}


@pytest.mark.parametrize("C,itemsize,address,want", [
    (20, 4, 0, 16), (20, 4, 4, 4), (20, 4, 8, 8), (9, 4, 0, 4), (64, 4, 0, 16), (129, 4, 0, 4),
    (33, 4, 0, 4), (1, 4, 0, 4), (20, 2, 0, 8), (9, 2, 0, 2), (16, 2, 0, 16), (2, 8, 0, 16),
    (1, 8, 0, 8), (3, 8, 0, 8),
    # K7 ORs its operands' addresses and row strides in bytes into the address
    (20, 4, 0x200 | 88, 8), (20, 4, 0x204 | 96, 4), (20, 8, 0x200 | 192, 16), (8, 8, 0x208 | 72, 8)])
def test_spmm_vector_bytes_takes_the_widest_aligned_load(C, itemsize, address, want):
    assert spmm_vector_bytes(C, itemsize, address) == want


# --------------------------------------------------------------------------
# K7's split of x's entries by K6's plan
# --------------------------------------------------------------------------

def _sddmm_split(a, gz, b, chunk, G):
    """A model of how K7 (``csrc/csr_spmm.cu``) assigns x's entries: a warp
    takes a chunk of K6's plan; 32 // G lane groups take consecutive
    entries a step; each group finds its entry's row by walking the chunk's
    row ends forward from its last one.  With G = 1 (a row of one vector)
    this is also the order in which ``csr_sddmm_lane_kernel``'s lanes take
    entries.  Returns how often each entry was taken, the row each resolved
    to and the float32 values written."""
    indptr, indices = a.indptr.numpy().astype(np.int64), a.indices.numpy()
    n, nnz = a.shape[0], a.nnz
    plan = merge_path_plan(a.indptr, nnz, chunk).numpy().astype(np.int64)
    groups = 32 // G
    taken, rows = np.zeros(nnz, np.int64), np.full(nnz, -1, np.int64)
    out = np.full(nnz, np.nan, np.float32)
    for c in range(len(plan) - 1):
        i0, i1 = plan[c], plan[c + 1]
        j0, j1 = min(c * chunk, n + nnz) - i0, min((c + 1) * chunk, n + nnz) - i1
        n_ent = j1 - j0
        ends = indptr[i0 + 1:i1 + 1] - j0            # the staged row ends, as offsets in the chunk

        def row_hi(r):
            return ends[r - i0] if r < i1 else n_ent  # row i1, cut by the chunk's end, runs to it

        walk = [(i0, row_hi(i0))] * groups
        for t0 in range(0, n_ent, groups):
            for g in range(groups):
                t = t0 + g
                if t >= n_ent:
                    continue
                r, hi = walk[g]
                while t >= hi:
                    r += 1
                    hi = row_hi(r)
                walk[g] = (r, hi)
                k = j0 + t
                taken[k] += 1
                rows[k] = r
                out[k] = np.dot(gz[r], b[indices[k]])
    return taken, rows, out


@pytest.mark.parametrize("C", [1, 20, 160], ids=lambda c: f"C{c}")
@pytest.mark.parametrize("chunk", [32, SPMM_CHUNK])
@pytest.mark.parametrize("which", sorted(PLAN_MATRICES))
def test_sddmm_split_takes_every_entry_once_at_its_row(which, chunk, C):
    x = PLAN_MATRICES[which]()
    a = CSRMat.from_scipy(x, CPU)
    gz, b = _rhs(x.shape[0], C, seed=26), _rhs(x.shape[1], C, seed=27)
    NV = C * 4 // spmm_vector_bytes(C, 4, 0)          # 16-byte loads where the row allows them
    taken, rows, got = _sddmm_split(a, gz, b, chunk, G=min(NV, 32))
    assert (taken == 1).all()
    np.testing.assert_array_equal(rows, row_ids(a).numpy())
    want = csr_sddmm_plain(a, torch.from_numpy(gz), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got, _sddmm_oracle(a.to_scipy(), gz, b).data, **F32)


def test_sddmm_rows_keep_column_slices_and_copy_the_rest():
    from aesara_tpu_torch.link.torch.kernels.sparse import _sddmm_rows

    wide = torch.randn(30, 24)
    sliced = _sddmm_rows(wide[:, 2:22], torch.float32)
    assert sliced.data_ptr() == wide[:, 2:22].data_ptr() and sliced.stride() == (24, 1)
    strided = _sddmm_rows(wide[:, ::2], torch.float32)
    assert strided.is_contiguous() and torch.equal(strided, wide[:, ::2])
    column = _sddmm_rows(wide[:, 3], torch.float32)
    assert column.shape == (30, 1) and column.data_ptr() == wide[:, 3].data_ptr()
    assert _sddmm_rows(wide[:, :5], torch.float64).dtype == torch.float64


def test_csr_sddmm_refuses_operands_of_other_widths():
    a = CSRMat.from_scipy(_rand_csr(30, 20, 0.2, seed=28), CPU)
    with pytest.raises(ValueError, match="csr_sddmm"):
        csr_sddmm(a, torch.ones(30, 4), torch.ones(20, 5))


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,group,counter", [
    ("void (anonymous namespace)::csr_sddmm_kernel<float, float, 16, false>(int const*, int const*)",
     "K7 CSR SDDMM", "K7"),
    ("void (anonymous namespace)::csr_sddmm_kernel<double, double, 8, true>(int const*, int const*)",
     "K7 CSR SDDMM", "K7"),
    ("void (anonymous namespace)::csr_sddmm_lane_kernel<float, float, 4>(int const*, int const*)",
     "K7 CSR SDDMM", "K7"),
    ("void (anonymous namespace)::csr_spmm_kernel<float, float, float, 16>(int const*)", "K6 CSR SpMM", "K6"),
    ("void (anonymous namespace)::csr_spmm_fixup_kernel<float>(int const*)", "K6 CSR SpMM", None),
    ("void (anonymous namespace)::csr_spmv_kernel<float, float, float>(int const*)", "K5 CSR SpMV", "K5"),
    ("void (anonymous namespace)::softmax_group_kernel<float, 16, 8, 1>(float const*, float*, long long, int)",
     "K4 row softmax", "K4"),
    ("void (anonymous namespace)::softmax_block_kernel<(anonymous namespace)::bf16, 16>(bf16 const*)",
     "K4 row softmax", "K4"),
    ("void (anonymous namespace)::softmax_two_pass_kernel<double, 8>(double const*, double*, int)",
     "K4 row softmax", "K4"),
    ("void at::native::(anonymous namespace)::softmax_warp_forward<float, float, float, 5, true, false>(float*)",
     "other torch", None),
    ("void (anonymous namespace)::flash_fwd_kernel<float, 64>(float const*, float const*)", "K2 flash forward",
     "K2"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<float, 64>(float const*, float const*)",
     "K3 flash backward", "K3"),
    ("void (anonymous namespace)::flash_bwd_dkdv_kernel<(anonymous namespace)::bf16, 128>(bf16 const*)",
     "K3 flash backward", None),
    ("kernel", "K1 fused Composite", "K1"),
    ("threefry_kernel", "TF threefry draw", "TF"),
])
def test_profile_groups_and_counts_every_csr_and_softmax_kernel(name, group, counter):
    """``chip_smoke.py`` reads a profiled step's kernels by name: each of
    K7's two kernels marks one K7 launch, K6's fix-up pass marks none; K3's
    dq pass marks one K3 launch and its dk/dv pass none; K2's forward (also
    run again inside K3) marks one K2 launch; a generated Triton kernel one
    K1, the threefry kernel one TF."""
    smoke = _chip_smoke()
    assert smoke.kernel_group(name) == group
    assert smoke.counted_kernel(name) == counter


def _trace_event(name, start_us, duration_us, device="CUDA"):
    from types import SimpleNamespace

    from torch.autograd.profiler_util import Interval

    return SimpleNamespace(name=name, time_range=Interval(start_us, start_us + duration_us),
                           device_type=getattr(torch.autograd.DeviceType, device))


_K6 = "void (anonymous namespace)::csr_spmm_kernel<float, float, float, 16>(int const*)"
_FIXUP = "void (anonymous namespace)::csr_spmm_fixup_kernel<float>(int const*)"


@pytest.mark.parametrize("spins,start", [
    # the opening edge's spin (50 ms), two markers (50 us), the closing edge's (100 ms)
    ([(0, 50_000), (150_000, 50), (150_060, 50), (152_000, 100_000)], 150_060),
    # the first marker, or all but the first, lost from the trace
    ([(150_060, 50)], 150_060),
    ([(0, 50_000), (150_000, 50), (152_000, 100_000)], 150_000),
    # every marker lost: nothing is counted
    ([(0, 50_000), (152_000, 100_000)], None),
])
def test_profile_counts_only_what_starts_after_the_marker(spins, start):
    """``chip_smoke.py`` counts a profiled window's kernels from the last
    short spin (a marker) that the trace kept after the lead-in call on:
    the lead-in's K6 launch, the spins and the profiler's step ranges are
    left out, and a trace without a marker counts nothing."""
    smoke = _chip_smoke()
    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [_trace_event(spin, s, d) for s, d in spins] + [
        _trace_event(_K6, 100_000, 10), _trace_event(_FIXUP, 100_012, 3),             # the lead-in
        _trace_event(_K6, 151_050, 10), _trace_event(_FIXUP, 151_062, 3),
        _trace_event(_K6, 151_400, 10), _trace_event("ProfilerStep#2", 150_900, 600),
        _trace_event(_K6, 151_600, 10), _trace_event("cudaGraphLaunch", 151_500, 5, device="CPU")]
    marker, device = smoke.after_marker(events)
    if start is None:
        assert (marker, device) == (None, [])
        return
    assert marker.start == start
    assert len(device) == 4
    assert [smoke.counted_kernel(e.name) for e in device].count("K6") == 3
