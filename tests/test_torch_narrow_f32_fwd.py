"""The f32 narrow forwards (route ``"narrow_f32"``) and the launchers'
route check on the CPU.

``csrc/{bilstm,bigru}_fwd_narrow_f32.cu`` run on the card only; what
surrounds them is replayed here in torch (``ops/narrow_f32_layout.py``): the
forward's plan of blocks, rows, bytes and waves, with W_h in shared memory
or in registers (held against the launchers' own plan on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``), the routes the card
measured faster, and a forward with its product summed in the kernels'
order against the plain twins and the Pallas kernels in interpret mode.
The four launchers refuse a route name they do not take before they build
or touch the card.

Tolerances: the replayed forward within 1e-6·max(1, max|v|) of the twins
(f32, the same math with the product summed in another order over T = 5
steps); within 1e-5·max(1, max|v|) of the Pallas kernels (f32, XLA's sums in
another order, as the BPTT's test holds them); the plan exactly.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.ops import lstm_pallas
from percivaltts_tpu_torch import _build
from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda
from percivaltts_tpu_torch.ops import narrow_f32_layout as nf
from percivaltts_tpu_torch.ops.gru_cuda import bigru_fwd_reference
from percivaltts_tpu_torch.ops.lstm_cuda import at_width, bilstm_fwd_reference
from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

GATES = {"lstm": 4, "gru": 3}
# blocks the H100 holds at once by the forward's cluster size U (1 block an
# SM: 512 threads of up to 128 registers fill its register file), as the
# launchers report them for U = 1, 2, 4, 7, 8 (chip_smoke.py phase 15a
# prints them), the other sizes an estimate; "resident": the kernel that
# holds W_h in registers, one block an SM
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 7: 15, 8: 15, "resident": 132,
                 **{u: 132 // u // 2 for u in (3, 5, 6, 9, 10, 11, 12, 13, 14, 15, 16)}}


def _inputs(cell, T, B, H, seed):
    """numpy-seeded f32 forward inputs of ``cell`` in the twins' order: gx,
    W_h (and b_hn) per direction."""
    rng = np.random.default_rng(seed)
    gates = GATES[cell]
    a = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))  # noqa: E731
    args = (a(T, B, gates * H), a(T, B, gates * H), a(H, gates * H, sc=H ** -0.5),
            a(H, gates * H, sc=H ** -0.5))
    return args if cell == "lstm" else (*args, a(H, sc=0.1), a(H, sc=0.1))


def _twin(cell, *args):
    if cell == "lstm":
        return bilstm_fwd_reference(*args, with_cells=True)
    return bigru_fwd_reference(*args)


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=tol * max(1.0, np.abs(w).max()))


# --- the launchers' routes ----------------------------------------------------------


def _launch_args(cell, kind):
    T, B, H = 2, 1, 8
    args = _inputs(cell, T, B, H, seed=0)
    if kind == "fwd":
        return args
    z = torch.zeros(T, B, H)
    return (*args, z, z, z, z, z, z, z, z)[:len(args) + (8 if cell == "lstm" else 4)]


LAUNCHERS = {("lstm", "fwd"): lstm_cuda.fwd_launch, ("lstm", "bwd"): lstm_cuda.bwd_launch,
             ("gru", "fwd"): gru_cuda.fwd_launch, ("gru", "bwd"): gru_cuda.bwd_launch}


@pytest.mark.parametrize("cell,kind", list(LAUNCHERS))
@pytest.mark.parametrize("route", ["bogus", "Narrow_f32", ""])
def test_launchers_refuse_a_route_they_do_not_take(monkeypatch, cell, kind, route):
    """Each of the four launchers raises ``ValueError`` naming the routes it
    takes for any other name, before it builds or touches the card (the
    build is replaced by a function that fails the test), on CPU tensors."""
    def no_build(*a, **k):
        raise AssertionError("the launcher reached the build")
    monkeypatch.setattr(_build, "library", no_build)
    takes = lstm_cuda.FWD_ROUTES if kind == "fwd" else lstm_cuda.BWD_ROUTES
    with pytest.raises(ValueError, match="takes the routes " + ", ".join(map(repr, takes))):
        LAUNCHERS[cell, kind](route, *_launch_args(cell, kind))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_forwards_refuse_wide_f32(monkeypatch, cell):
    """The forwards take ``"mma"``, ``"simt"``, ``"wide_mma"``,
    ``"wide_mma_stream"``, ``"wide"``, ``"wide_f32"`` and ``"narrow_f32"``,
    the BPTTs the same routes (bf16 past the "wide_mma" widths both passes
    stream their slice, ``"wide_mma_stream"``); a forward
    refuses ``"wide_f32"`` outside f32 at 128 < H <= 512 before it builds
    (bf16: ``TypeError``; H = 8, the narrow width here: ``ValueError``)."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("the launcher reached the build"))
    assert lstm_cuda.FWD_ROUTES == ("mma", "simt", "wide_mma", "wide_mma_stream", "wide",
                                    "wide_f32", "narrow_f32")
    assert lstm_cuda.BWD_ROUTES == lstm_cuda.FWD_ROUTES
    with pytest.raises(ValueError, match="H <= 512, got H=8"):
        LAUNCHERS[cell, "fwd"]("wide_f32", *_launch_args(cell, "fwd"))
    bf16 = tuple(t.to(torch.bfloat16) for t in _launch_args(cell, "fwd"))
    with pytest.raises(TypeError, match="float32"):
        LAUNCHERS[cell, "fwd"]("wide_f32", *bf16)


# --- the sums against the twins and the Pallas kernels ----------------------------


@pytest.mark.parametrize("cell,H,blocks", [
    ("lstm", 64, 1), ("lstm", 96, 4), ("lstm", 128, 8), ("lstm", 160, 8), ("lstm", 256, 8),
    ("gru", 64, 1), ("gru", 128, 1), ("gru", 128, 8), ("gru", 224, 5), ("gru", 320, 8),
])
def test_replayed_forward_matches_the_twins(cell, H, blocks):
    """The forward summed in the kernels' order (``replay_fwd``: each block's
    product over four k lanes, added ((s0 + s1) + (s2 + s3)); at one block
    also the order of the kernel that holds W_h in registers; LSTM H = 160
    over 7 blocks of 24 units and GRU H = 224 over 5 of 48, their last
    blocks short) within 1e-6 of the twins, the LSTM's cells too."""
    s = nf.split(H, blocks, GATES[cell])
    assert s.U <= blocks and (s.U - 1) * s.Hb < H <= s.U * s.Hb
    args = _inputs(cell, 5, 3, H, seed=H)
    _close(nf.replay_fwd(cell, *args, blocks=blocks), _twin(cell, *args), 1e-6)


@pytest.mark.parametrize("cell,blocks", [("lstm", 8), ("gru", 1)])
def test_replayed_forward_matches_the_pallas_kernel(cell, blocks):
    """The replayed forward at f32 H = 128 (T = 9, B = 3), on the split the
    plan takes there (the LSTM over 8 blocks, the GRU's W_h in one block's
    registers), equals ``_bilstm_fwd_pallas`` / ``_bigru_fwd_pallas`` in
    interpret mode on the same numpy-seeded inputs."""
    args = _inputs(cell, 9, 3, 128, seed=9)
    pallas = lstm_pallas._bilstm_fwd_pallas if cell == "lstm" else lstm_pallas._bigru_fwd_pallas
    want = pallas(*(jnp.asarray(a.numpy()) for a in args), interpret=True)
    _close(nf.replay_fwd(cell, *args, blocks=blocks), want, 1e-5)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_forward_padding_is_exact_through_the_replay(cell):
    """A width the kernels do not take (H = 100) run zero-padded to 104
    through the replay equals the twin at 100 (``at_width``)."""
    args = _inputs(cell, 4, 2, 100, seed=5)
    got = at_width(lambda *a: nf.replay_fwd(cell, *a, blocks=4), nf.padded(100), GATES[cell],
                   *args)
    _close(got, _twin(cell, *args), 1e-6)


# --- the plan ------------------------------------------------------------------------------


def _cost(B, H, gates, p):
    if p.resident:
        return nf.reg_step_cost(H, gates, p.R)
    return p.waves * nf.fwd_step_cost(H, nf.Split(*p[:4]), p.R)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("B", [1, 8, 32, 160])
def test_fwd_plan_fits_at_the_path_batches(cell, B):
    """At H = 64, 128 and the route's widest H, B = 1, 8, 32, 160 on the
    H100's clusters: a plan whose block fits 232,448 bytes (the W_h slice, two
    buffers of h rows and the z rows, as ``fwd_smem_bytes`` counts them), at
    most 2 (row, unit) pairs a thread, and the fewest waves any candidate
    gives; or W_h in the registers of one block of 4H threads, 96 words a
    thread at most, its 2·ceil(B / R) blocks in one wave."""
    gates = GATES[cell]
    for H in (64, 128, nf.MAX_H[gates]):
        p = nf.fwd_plan(B, H, gates, H100_CLUSTERS)
        s = nf.Split(*p[:4])
        if p.resident:
            assert nf.reg_fits(H, gates) and gates * H // 4 <= nf.REG_MAX_WORDS
            assert (p.U, p.Hb, p.smem) == (1, H, nf.REG_SMEM) and p.R in nf.REG_ROWS
            assert 2 * -(-B // p.R) <= H100_CLUSTERS["resident"] and p.waves == 1
            continue
        ws = s.NCP + 4
        parts = {"w": H * ws, "h": 2 * p.R * H, "z": p.R * ws}
        assert p.smem == 4 * sum(parts.values()) == nf.fwd_smem_bytes(H, s, p.R) <= nf.SMEM_OPTIN
        assert p.R * s.Hb <= nf.MAX_PAIRS * nf.THREADS and p.R in nf.ROWS
        assert p.clusters == H100_CLUSTERS[s.U]
        assert p.waves == -(-2 * -(-B // p.R) // p.clusters)
        fewest = min(-(-2 * -(-B // R) // H100_CLUSTERS[c.U])
                     for c, R, _ in nf.candidates(H, gates, fwd=True))
        assert p.waves <= max(fewest, 1) + 1


def test_fwd_plan_takes_the_least_estimate_and_its_overrides():
    """The forward's plan is the candidate of least estimate (a shared-memory
    plan's ``waves × fwd_step_cost``, the resident kernel's
    ``reg_step_cost`` where its blocks fit one wave), the shared-memory plan
    on a tie; ``blocks``, ``rows`` and ``resident`` restrict the candidates as
    the launchers' overrides do, and a forced plan that fits nothing raises."""
    for B in (1, 2, 4, 8, 16, 32, 100, 160):
        for H, gates in ((64, 4), (96, 4), (128, 4), (256, 4), (64, 3), (128, 3), (320, 3)):
            p = nf.fwd_plan(B, H, gates, H100_CLUSTERS)
            costs = [-(-2 * -(-B // R) // H100_CLUSTERS[s.U]) * nf.fwd_step_cost(H, s, R)
                     for s, R, _ in nf.candidates(H, gates, fwd=True)]
            if nf.reg_fits(H, gates):
                costs += [nf.reg_step_cost(H, gates, R) for R in nf.REG_ROWS
                          if 2 * -(-B // R) <= H100_CLUSTERS["resident"]]
            assert min(costs) == _cost(B, H, gates, p)
            forced = nf.fwd_plan(B, H, gates, H100_CLUSTERS, blocks=p.U, rows=p.R,
                                 resident=p.resident)
            assert forced == p
            shared = nf.fwd_plan(B, H, gates, H100_CLUSTERS, resident=0)
            assert not shared.resident and _cost(B, H, gates, shared) >= _cost(B, H, gates, p)
    assert nf.fwd_plan(8, 128, 3, H100_CLUSTERS).resident == 1
    assert nf.fwd_plan(8, 128, 3, H100_CLUSTERS, rows=2).R == 2
    assert nf.fwd_plan(160, 128, 3, H100_CLUSTERS).resident == 0  # two waves: shared memory
    assert nf.fwd_plan(8, 128, 4, H100_CLUSTERS, blocks=8).U == 8
    with pytest.raises(ValueError, match="no f32 narrow forward plan"):
        nf.fwd_plan(8, 128, 4, H100_CLUSTERS, resident=1)  # 128 words a thread
    with pytest.raises(ValueError, match="no f32 narrow forward plan"):
        nf.fwd_plan(8, 256, 4, H100_CLUSTERS, blocks=1)  # 1 MiB of W_h in one block


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_every_width_the_forward_route_takes_has_a_plan(cell):
    """f32 up to the one-block kernels' widest H (LSTM 256, GRU 320): every
    width pads to a multiple of 8 and has a forward plan at B = 1 and 160 on
    the H100, W_h in registers only where ``reg_fits``; the forward takes
    ``"narrow_f32"`` there without a batch, the BPTT too; past it the
    cluster routes; bf16 is not this route's."""
    gates = GATES[cell]
    top = nf.MAX_H[gates]
    for H in range(1, top + 1):
        Hp = nf.padded(H)
        for B in (1, 160):
            p = nf.fwd_plan(B, Hp, gates, H100_CLUSTERS)
            assert p.smem <= nf.SMEM_OPTIN and (not p.resident or nf.reg_fits(Hp, gates))
        assert fwd_route(torch.float32, H, cell) == bwd_route(torch.float32, H, cell) == "narrow_f32"
    assert fwd_route(torch.float32, top + 1, cell) == "wide_f32"
    for H in (16, 100, 128):
        assert fwd_route(torch.bfloat16, H, cell) in ("mma", "simt")


# the f32 forwards timed in turns on the H100 (python3 chip_smoke.py
# --f32-times, T = 512, B = 1, 2, 4, 8, 16, 32, 160): at each width, the
# largest B at which the one-block kernel ("simt") was faster than
# "narrow_f32" (0: at none; "narrow_f32" was 1.20–5.45× faster at all 77)
SIMT_FASTER_UP_TO = {"lstm": {64: 0, 96: 0, 128: 0, 160: 0, 192: 0, 256: 0},
                     "gru": {64: 0, 128: 0, 192: 0, 256: 0, 320: 0}}


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_f32_forward_route_takes_the_kernel_measured_faster(cell):
    """At every width the card timed, the f32 forward takes the kernel it
    measured faster at every batch: ``"narrow_f32"`` (no table keeps the
    one-block kernel)."""
    for H, up_to in SIMT_FASTER_UP_TO[cell].items():
        assert up_to == 0
        assert fwd_route(torch.float32, H, cell) == "narrow_f32", H
