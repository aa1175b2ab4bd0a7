"""The port's parallel layer (``libtsd_tpu_torch.parallel``) against the
JAX package's on the CPU, on the same numpy inputs: the JAX side on the
8-device virtual CPU mesh that tests/conftest.py sets, the port on
``make_mesh(..., devices=["cpu"] * 8)``, the same single-controller mesh of
8 virtual shards.  Each test here is the counterpart of one in
tests/test_parallel.py, with its tolerance:

* 1e-4 absolute (``check_max_error``): sharded FIR, chain, IIR and SOS
  stages (tests/test_parallel.py:32,55,241,288), here against JAX's
  sharded output;
* the sharded fused chain, both halo forms: 1e-5 of the peak against
  JAX's sharded result (the file's one interpreted Pallas call, the
  "ppermute" form at C = 2, 2 x 8192) and 1e-4 against the float64 numpy
  oracle (:96-103); split precision 1e-2 (:125);
* the overlap-save OLA stage (kernel #9's plain version): 1e-5 of the peak
  (:223);
* the sharded FM receiver: 2e-3 against JAX (:315), and 1e-4 after 16
  outputs against the unsharded receiver on the longer case (:366);
* kernel #11's plain version: each shard's partial spectrum equals #3's
  plain version given its left neighbour's tail (the same arithmetic);
* #11 across processes, its card and the other ranks faked: the order of
  its launches and collectives, on the sharded path and called directly.

The last test runs the launch path in two gloo processes on localhost.
"""
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import receivers as RXj
from libtsd_tpu.ops import filter_rt as FRj
from libtsd_tpu.ops import fir_design as FDj
from libtsd_tpu.ops import iir_design as IDj
from libtsd_tpu.parallel import channel_sharding
from libtsd_tpu.parallel import make_mesh as make_mesh_j
from libtsd_tpu.parallel import sharded_chain as sharded_chain_j
from libtsd_tpu.parallel import sharded_fm_receiver as sharded_fm_j
from libtsd_tpu.utils.testing import check_max_error
from libtsd_tpu_torch.block import Chain
from libtsd_tpu_torch.models.receivers import FmReceiver, FmReceiverConfig
from libtsd_tpu_torch.ops import filter_rt as FR
from libtsd_tpu_torch.ops import fir_design as FD
from libtsd_tpu_torch.ops import iir_design as ID
from libtsd_tpu_torch.ops.kernels import chain as KC, chain_halo as KH
from libtsd_tpu_torch.parallel import (gather, halo_exchange_left, launch,
                                       make_mesh, shard, sharded_chain,
                                       sharded_fir,
                                       sharded_fir_periodogram4096,
                                       sharded_fm_receiver)
from libtsd_tpu_torch.parallel.mesh import ROW_TIMEOUT, Mesh, RowLink
from torch_compare import THREAD_ENV  # (importing it caps the threads)

CPU8 = ["cpu"] * 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mesh_pair(chan, time):
    return (make_mesh_j(chan=chan, time=time),
            make_mesh(chan=chan, time=time, devices=CPU8))


def jput(mesh, x):
    return jax.device_put(jnp.asarray(x), channel_sharding(mesh))


def t32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def oracle(h, x):
    """Float64 numpy FIR then the sum of |FFT-4096|^2 over frames."""
    y = np.stack([np.convolve(r, h)[:x.shape[1]] for r in
                  np.asarray(x, np.float64)])
    return (np.abs(np.fft.fft(y.reshape(x.shape[0], -1, 4096))) ** 2).sum(1)


def peak_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# ---------------------------------------------------------------- mesh


@pytest.mark.parametrize("chan,time,want", [(2, 4, {"chan": 2, "time": 4}),
                                            (None, 2, {"chan": 4, "time": 2}),
                                            (2, 3, {"chan": 2, "time": 3})])
def test_mesh_shapes(chan, time, want):
    mj = make_mesh_j(chan=chan, time=time)
    m = make_mesh(chan=chan, time=time, devices=CPU8)
    assert m.shape == dict(mj.shape) == want
    assert m.axis_names == tuple(mj.axis_names)
    assert [len(r) for r in m.devices] == [want["time"]] * want["chan"]


@pytest.mark.parametrize("kw,match", [({"time": 3}, "does not divide"),
                                      ({"time": 16}, "does not fit"),
                                      ({"chan": 3, "time": 3}, "exceeds")])
def test_make_mesh_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        make_mesh_j(**kw)
    with pytest.raises(ValueError, match=match):
        make_mesh(devices=CPU8, **kw)


def test_make_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_mesh() builds on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_shard_gather_and_halo_exchange():
    m = make_mesh(chan=2, time=4, devices=CPU8)
    x = torch.arange(4 * 64, dtype=torch.float32).reshape(4, 64)
    grid = shard(m, x)
    assert [[tuple(p.shape) for p in r] for r in grid] == [[(2, 16)] * 4] * 2
    assert torch.equal(gather(m, grid), x)
    halos = halo_exchange_left(grid[1], 5)
    assert torch.equal(halos[0], torch.zeros(2, 5))
    for t in range(1, 4):
        assert torch.equal(halos[t], x[2:, 16 * t - 5:16 * t])
    assert all(h.shape == (2, 0) for h in halo_exchange_left(grid[0], 0))
    with pytest.raises(ValueError, match="exceeds the local shard"):
        halo_exchange_left(grid[0], 17)


# ----------------------------------------------------- FIR / chain stages


@pytest.mark.parametrize("case", ["fir", "fir_time_only", "two_stages",
                                  "grid_in_grid_out"])
def test_sharded_fir_stages_match_jax(case):
    rng = np.random.default_rng(11)
    if case == "fir":
        (chan, time), C, N = (2, 4), 4, 1024
        stages = [((65, 0.1), 64)]
    elif case == "fir_time_only":
        (chan, time), C, N = (1, 8), 2, 2048
        stages = [((33, 0.2), 32)]
    elif case == "two_stages":
        (chan, time), C, N = (2, 4), 2, 1024
        stages = [((33, 0.2), 32), ((17, 0.3), 16)]
    else:
        (chan, time), C, N = (4, 2), 8, 512
        stages = [((33, 0.15), 32)]
    mj, m = mesh_pair(chan, time)
    x = rng.standard_normal((C, N)).astype(np.float32)
    hs = [FDj.fir_lowpass(k, fc) for (k, fc), _ in stages]
    sj = [(FRj.Fir.create(h), s) for h, (_, s) in zip(hs, stages)]
    yj = np.asarray(jax.jit(lambda v: sharded_chain_j(mj, sj, v))(
        jput(mj, x)))
    blocks = [(FR.Fir.create(FD.fir_lowpass(k, fc), device="cpu"), s)
              for (k, fc), s in stages]
    if case == "grid_in_grid_out":
        grid = sharded_fir(m, blocks[0][0], shard(m, t32(x)), blocks[0][1])
        assert [[tuple(p.shape) for p in r] for r in grid] == \
            [[(2, 256)] * 2] * 4
        y = gather(m, grid)
    elif len(blocks) == 1:
        y = sharded_fir(m, blocks[0][0], t32(x), blocks[0][1])
    else:
        y = sharded_chain(m, blocks, t32(x))
    check_max_error(y.numpy(), yj, 1e-4)
    ref = t32(x)
    for h in hs:
        ref = FR.fir_filter(h, ref)
    check_max_error(y.numpy(), ref.numpy(), 1e-4)


def test_sharded_ola_matches_unsharded():
    """Overlap-save OLA (engine "cuda", #9's plain version on the CPU) as a
    tail-state stage: its state is the last V inputs, the halo."""
    rng = np.random.default_rng(12)
    m = make_mesh(chan=2, time=4, devices=CPU8)
    h = rng.standard_normal(129).astype(np.float32)
    blk = FR.OlaFft.create(h, Ne=256, engine="cuda", device="cpu")
    C, N = 2, 4 * 2 * blk.Ne
    x = (rng.standard_normal((C, N))
         + 1j * rng.standard_normal((C, N))).astype(np.complex64)
    y = sharded_fir(m, blk, torch.as_tensor(x), blk.V)
    y_ref = np.asarray(FRj.fir_filter(h, jnp.asarray(x)))
    assert peak_rel(y.numpy(), y_ref) < 1e-5


# ------------------------------------------------- time-sharded recursion


def _recursive_stage(case):
    if case == "butter2":
        b, a = IDj.design_iir(2, "lp", "butt", 0.1).to_ba()
        return [(FRj.IirFrame.create(b, a), 0)], \
            [(FR.IirFrame.create(b, a, device="cpu"), 0)]
    if case == "lexp_order1":
        b, a = IDj.design_lexp(0.05)
        return [(FRj.IirFrame.create(b, a), 0)], \
            [(FR.IirFrame.create(b, a, device="cpu"), 0)]
    if case == "fir_then_iir":
        h = FDj.fir_lowpass(33, 0.2)
        b, a = IDj.design_iir(2, "lp", "butt", 0.08).to_ba()
        return ([(FRj.Fir.create(h), 32), (FRj.IirFrame.create(b, a), 0)],
                [(FR.Fir.create(h, device="cpu"), 32),
                 (FR.IirFrame.create(b, a, device="cpu"), 0)])
    sos, k = IDj.zpk_to_sos(IDj.design_iir(4, "lp", "ellip", 0.1, 0.5, 40.0))
    return ([(FRj.sos_frame_chain(sos, k), 0)],
            [(FR.sos_frame_chain(sos, k, device="cpu"), 0)])


@pytest.mark.parametrize("case", ["butter2", "lexp_order1", "fir_then_iir",
                                  "sos_chain"])
def test_iir_time_sharded_matches_jax(case):
    rng = np.random.default_rng(13)
    mj, m = mesh_pair(2, 4)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    sj, st = _recursive_stage(case)
    yj = np.asarray(jax.jit(lambda v: sharded_chain_j(mj, sj, v))(
        jput(mj, x)))
    y = sharded_chain(m, st, t32(x))
    check_max_error(y.numpy(), yj, 1e-4)
    # and against the port's own unsharded cascade
    ref = t32(x)
    for blk, _ in st:
        ref = blk.step(blk.init_for(ref), ref)[1]
    check_max_error(y.numpy(), ref.numpy(), 1e-4)


def test_iir_time_sharded_complex_and_grid():
    """Complex input runs re and im through the composition; one time
    shard is the plain frame-parallel step."""
    rng = np.random.default_rng(14)
    b, a = ID.design_iir(2, "lp", "butt", 0.1).to_ba()
    blk = FR.IirFrame.create(b, a, device="cpu")
    x = torch.as_tensor((rng.standard_normal((2, 2048)) + 1j
                         * rng.standard_normal((2, 2048))).astype(np.complex64))
    ref = blk.step(blk.init_for(x), x)[1]
    for time in (1, 4):
        m = make_mesh(chan=1, time=time, devices=CPU8)
        y = sharded_chain(m, [(blk, 0)], x[:1])
        check_max_error(y.numpy(), ref[:1].numpy(), 1e-4)


@pytest.mark.parametrize("case,match", [("iir", "recursion"),
                                        ("sos", "recursion"),
                                        ("mixed_chain", "mixing"),
                                        ("ola_torch", "tail_state")])
def test_sharded_chain_rejects_raw_recursive_blocks(case, match):
    """A block whose state is NOT an input-sample tail is rejected loudly
    (an order-1 Iir's state even has the right shape for a 1-sample
    halo)."""
    b, a = ID.design_lexp(0.1)
    iir = FR.Iir.create(b, a, device="cpu")
    blk = {"iir": iir,
           "sos": FR.Sos.create(np.array([[1.0, 0, 0, 1, -0.5, 0]]),
                                device="cpu"),
           "mixed_chain": Chain([FR.Fir.create([1.0, 0.5], device="cpu"),
                                 iir]),
           "ola_torch": FR.OlaFft.create(np.ones(9), device="cpu")}[case]
    m = make_mesh(chan=4, time=2, devices=CPU8)
    x = torch.zeros((8, 256))
    with pytest.raises(TypeError, match=match):
        sharded_chain(m, [(blk, 1)], x)
    if case == "iir":
        mj = make_mesh_j(chan=4, time=2)
        with pytest.raises(TypeError, match=match):
            sharded_chain_j(mj, [(FRj.Iir.create(b, a), 1)],
                            jnp.zeros((8, 256), jnp.float32))


# ------------------------------------------------- sharded fused chain


@pytest.fixture(scope="module")
def fused_jax():
    """The file's one interpreted Pallas call: JAX's sharded chain, the
    "ppermute" form, on a (1, 2) mesh at C = 2, 2 x 8192."""
    from libtsd_tpu.parallel import sharded_fir_periodogram4096 as sfp_j
    rng = np.random.default_rng(15)
    h = FDj.fir_lowpass(200, 0.15)
    G = FR.fir_toeplitz_mats(np.asarray(h, np.float64)).astype(np.float32)
    x = rng.standard_normal((2, 2 * 8192)).astype(np.float32)
    mj = make_mesh_j(chan=1, time=2)
    acc = np.asarray(sfp_j(mj, jput(mj, x), jnp.asarray(G), halo="ppermute",
                           tb=1, precision="highest", interpret=True))
    return h, G, x, acc


@pytest.mark.parametrize("halo", ["ppermute", "fused"])
def test_sharded_fused_chain_matches_jax(fused_jax, halo):
    h, G, x, acc_j = fused_jax
    m = make_mesh(chan=1, time=2, devices=CPU8)
    acc = sharded_fir_periodogram4096(m, t32(x), t32(G), precision="highest",
                                      halo=halo)
    assert acc.shape == (2, 4096)
    assert peak_rel(acc.numpy(), acc_j) < 1e-5
    assert peak_rel(acc.numpy(), oracle(h, x)) < 1e-4


@pytest.mark.parametrize("halo", ["ppermute", "fused"])
@pytest.mark.parametrize("chan,time,K,precision,tol",
                         [(2, 4, 200, "highest", 1e-4),
                          (4, 2, 128, "split", 1e-2),
                          (2, 4, 256, "int16", 1e-4)])
def test_sharded_fused_chain_matches_numpy(halo, chan, time, K, precision,
                                           tol):
    """Against the float64 numpy oracle (tests/test_parallel.py:98-103)
    and the unsharded chain (1e-5 of the peak, :96)."""
    rng = np.random.default_rng(K)
    m = make_mesh(chan=chan, time=time, devices=CPU8)
    h = FD.fir_lowpass(K, 0.15)
    G = t32(FR.fir_toeplitz_mats(np.asarray(h, np.float64)))
    C, N = 4, time * 8192
    if precision == "int16":
        x = torch.as_tensor(rng.integers(-2048, 2048, (C, N)),
                            dtype=torch.int16)
    else:
        x = t32(rng.standard_normal((C, N)))
    acc = sharded_fir_periodogram4096(m, x, G, precision=precision, halo=halo)
    assert peak_rel(acc.numpy(), oracle(h, x.numpy())) < tol
    one = KC.fir_periodogram4096(x, G, precision=precision)
    assert peak_rel(acc.numpy(), one.numpy()) < 1e-5


@pytest.mark.parametrize("precision", ["highest", "bf16", "int8", "int16"])
@pytest.mark.parametrize("K,with_hist0", [(1, False), (100, True),
                                          (256, True), (256, False)])
def test_halo_plain_is_chain_plain_with_left_tail(precision, K, with_hist0):
    """Kernel #11's plain version, shard by shard: #3's plain version with
    the left neighbour's last (D - 1) 128 samples as hist0 (shard 0: the
    caller's hist0); D = 1, 2 and 3."""
    rng = np.random.default_rng(K)
    G = t32(FR.fir_toeplitz_mats(rng.standard_normal(K)))
    D = G.shape[0]
    H = max(D - 1, 1)
    if precision in ("int8", "int16"):
        dt = torch.int8 if precision == "int8" else torch.int16
        lim = 127 if precision == "int8" else 2000
        x = torch.as_tensor(rng.integers(-lim, lim, (3, 3 * 4096)), dtype=dt)
        h0 = torch.as_tensor(rng.integers(-lim, lim, (3, H, 128)), dtype=dt)
    else:
        x = t32(rng.standard_normal((3, 3 * 4096)))
        h0 = t32(rng.standard_normal((3, H, 128)))
    h0 = h0 if with_hist0 else None
    xs = list(x.chunk(3, dim=1))
    parts = KH.fir_periodogram4096_halo(xs, G, h0, precision)
    for t, p in enumerate(parts):
        hist = h0 if t == 0 else (
            xs[t - 1][:, -(D - 1) * 128:].reshape(3, D - 1, 128)
            if D > 1 else None)
        ref = KC.fir_periodogram4096_plain(xs[t], G, hist, precision)
        assert torch.equal(p, ref)
    whole = KC.fir_periodogram4096_plain(x, G, h0, precision)
    assert peak_rel(sum(parts).numpy(), whole.numpy()) < 1e-5


def test_halo_plain_rejects_halo_longer_than_shard():
    G = t32(FR.fir_toeplitz_mats(np.ones(4098)))
    with pytest.raises(ValueError, match="exceeds the local shard"):
        KH.fir_periodogram4096_halo([torch.zeros(1, 4096)] * 2, G)


@pytest.mark.parametrize("card", [0, 1])
def test_halo_rejects_a_row_mixing_cpu_and_card(monkeypatch, card):
    """#11 takes its route from every shard of a row: a row with a shard on
    a card and one on the CPU raises, whichever comes first, instead of
    running the plain version on the card's shard.  The card's shard is
    stood in for by one that the route check takes for a CUDA tensor."""
    from libtsd_tpu_torch.ops.kernels import _build
    G = t32(FR.fir_toeplitz_mats(FD.fir_lowpass(256, 0.2)))
    row = [torch.zeros(2, 4096) for _ in range(2)]
    on_card = row[card]
    monkeypatch.setattr(_build, "use_plain", lambda t: t is not on_card)
    with pytest.raises(ValueError, match="mixes CPU and CUDA"):
        KH.fir_periodogram4096_halo(row, G)
    m = make_mesh(chan=1, time=2, devices=CPU8)
    with pytest.raises(ValueError, match="mixes CPU and CUDA"):
        sharded_fir_periodogram4096(m, [row], G, halo="fused")


# #11 across processes, seen from one rank: where the rank sits in a row of
# four (its left and right ranks) and the transport; the card and the other
# ranks are faked (``card``)
POSITIONS = {"first": (None, 1), "middle": (0, 2), "last": (2, None)}


class _FakeCard:
    """What #11's wrapper does to the card and the other ranks, in order:
    ``log`` of launches (with the call's epoch), collectives and
    point-to-point calls; ``waits``: each launch's limit on a shard's wait
    for its flag, in ns.  ``bufs``: the HaloBuffers whose epoch the left
    rank's token carries."""

    def __init__(self):
        self.log, self.waits, self.bufs = [], [], None

    def fir_periodogram4096_halo(self, *args):
        self.log.append(("launch", int(args[-2])))
        self.waits.append(int(args[-3]))
        return 0

    def calls(self, n: int) -> list:
        """The log cut into n calls of equal length."""
        k = len(self.log) // n
        assert len(self.log) == k * n, self.log
        return [self.log[i * k:(i + 1) * k] for i in range(n)]


@pytest.fixture
def card(monkeypatch):
    """#11's wrapper on its kernel route with the card and the other ranks
    faked (:class:`_FakeCard`); the shards stay CPU tensors and the slots
    are CPU tensors made at the first call."""
    import contextlib
    import types
    from libtsd_tpu_torch.ops.kernels import _build
    import torch.distributed as dist
    fake = _FakeCard()
    log = fake.log

    def fit(bufs, devices, C, P, dtype):
        if bufs.key is None:
            bufs.key = (tuple(devices), C, P, dtype)
            bufs.recv = [torch.zeros((2, C, P), dtype=dtype)]
            bufs.flags = [torch.zeros((2, C), dtype=torch.int32)]
            bufs.peer = (devices[-1], 1 << 20)
            bufs.tick = torch.zeros(1, dtype=torch.int32)

    def recv(t, src, group=None):
        t.fill_(fake.bufs.epoch)
        log.append(("recv", src))

    monkeypatch.setattr(_build, "use_plain", lambda t: False)
    monkeypatch.setattr(_build, "require_cuda", lambda *t: None)
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(KH.HaloBuffers, "fit", fit)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: log.append(("sync",)))
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: log.append(
        ("all_reduce", group, tuple(t.shape), t.dtype)))
    monkeypatch.setattr(dist, "recv", recv)
    monkeypatch.setattr(dist, "send", lambda t, dst, group=None: log.append(
        ("send", dst)))
    monkeypatch.setattr(dist, "barrier", lambda group=None: log.append(
        ("barrier", group)))
    return fake


def _row_mesh(position: str, transport: str) -> Mesh:
    """This rank's one-shard segment of a row of four across processes."""
    left, right = POSITIONS[position]
    t0 = 0 if left is None else left + 1
    link = RowLink(0, "row group", (0, 1, 2, 3), left, right, t0, 4,
                   transport, torch.device("cpu"), True)
    return Mesh([[torch.device("cpu")]], 1, 4, rows=[0], tstart=[t0],
                links=[link])


def _row_input(calls: int):
    G = t32(FR.fir_toeplitz_mats(FD.fir_lowpass(256, 0.2)))
    g = torch.Generator().manual_seed(5)
    xs = [torch.randint(-2048, 2048, (2, 4096), generator=g,
                        dtype=torch.int16) for _ in range(calls)]
    return G, xs


def _ordered_call(transport: str, position: str, e: int) -> list:
    """What #11's wrapper does for call e when it orders the call itself:
    the NCCL row barrier (a one-word all-reduce over the row's group), or
    gloo's token from the left, a wait for the card, the token to the
    right and a row barrier, around the launch."""
    left, right = POSITIONS[position]
    if transport == "nccl":
        return [("all_reduce", "row group", (1,), torch.int32),
                ("launch", e)]
    return ([("recv", left)] if left is not None else []) + [
        ("launch", e), ("sync",)] + (
        [("send", right)] if right is not None else []) + [
        ("barrier", "row group")]


ROW_SUM = ("all_reduce", "row group", (2, 4096), torch.float32)


@pytest.mark.parametrize("position", list(POSITIONS))
def test_sharded_fused_row_sum_follows_every_launch(card, position):
    """The fact that lets the sharded chain drop #11's row barrier on the
    NCCL transport: on every rank of a row, each call's launch is followed
    by the all-reduce of the row's sum over the row's group, and by no
    other collective, before the next call's launch.  The sum then
    completes only after every rank's kernel of the call, and each rank's
    next kernel queues behind it."""
    m = _row_mesh(position, "nccl")
    G, xs = _row_input(8)
    for x in xs:
        sharded_fir_periodogram4096(m, [[x]], G, precision="int16",
                                    halo="fused", fir_passes=2)
    for e, events in enumerate(card.calls(8), start=1):
        assert events == [("launch", e), ROW_SUM], events


@pytest.mark.parametrize("position", list(POSITIONS))
@pytest.mark.parametrize("transport", ["nccl", "gloo"])
def test_halo_called_directly_orders_its_calls(card, transport,
                                               position):
    """#11's wrapper called on its own across processes orders every call
    itself (:func:`_ordered_call`); the sharded chain keeps gloo's token
    too, before its row sum."""
    m = _row_mesh(position, transport)
    bufs = card.bufs = m.halo_buffers[0] = KH.HaloBuffers(m.links[0])
    G, xs = _row_input(4)
    for x in xs:
        KH.fir_periodogram4096_halo([x], G, None, "int16", 2, bufs=bufs)
    for e, events in enumerate(card.calls(4), start=1):
        assert events == _ordered_call(transport, position, e), events
    if transport == "gloo":
        card.log.clear()
        sharded_fir_periodogram4096(m, [[xs[0]]], G, precision="int16",
                                    halo="fused", fir_passes=2)
        assert card.log == _ordered_call("gloo", position, 5) + [ROW_SUM]


@pytest.mark.parametrize("how", ["sharded", "direct"])
@pytest.mark.parametrize("transport", ["nccl", "gloo"])
def test_halo_wait_limit_follows_who_orders(card, transport, how):
    """How long #11 lets a shard wait for its flag before it traps: the
    row group's timeout where the sharded chain's row sum alone orders the
    calls (a late neighbour's host is then waited for inside #11, as long
    as the barrier would have waited), 10 s where the wrapper orders them
    and the neighbours start together."""
    m = _row_mesh("middle", transport)
    link = m.links[0]
    assert link.timeout == ROW_TIMEOUT
    bufs = card.bufs = m.halo_buffers[0] = KH.HaloBuffers(link)
    G, xs = _row_input(3)
    for x in xs:
        if how == "sharded":
            sharded_fir_periodogram4096(m, [[x]], G, precision="int16",
                                        halo="fused", fir_passes=2)
        else:
            KH.fir_periodogram4096_halo([x], G, None, "int16", 2, bufs=bufs)
    limit_s = (ROW_TIMEOUT.total_seconds()
               if (how, transport) == ("sharded", "nccl") else 10)
    assert card.waits == [int(limit_s * 10**9)] * 3


# ------------------------------------------------- sharded FM receiver


def test_sharded_fm_receiver_matches_jax():
    cfg = dict(channel_freq=0.22, decim=4, deemph_fc=0.05)
    mj, m = mesh_pair(2, 4)
    C, N = 2, 8192
    k = np.arange(N)
    audio = np.stack([0.7 * np.sin(2 * np.pi * 0.004 * k),
                      0.5 * np.sin(2 * np.pi * 0.007 * k)])
    dev = RXj.FmReceiverConfig(**cfg).deviation
    ph = 2 * np.pi * (np.mod(0.22 * k, 1.0)
                      + dev / 4 * np.cumsum(audio, axis=1))
    x = np.exp(1j * ph).astype(np.complex64)
    fmj = RXj.FmReceiver.create(RXj.FmReceiverConfig(**cfg))
    yj = np.asarray(jax.jit(lambda v: sharded_fm_j(mj, fmj, v))(
        jput(mj, x)))
    fm = FmReceiver.create(FmReceiverConfig(**cfg), device="cpu")
    y = sharded_fm_receiver(m, fm, torch.as_tensor(x))
    assert y.shape == (C, N // 4)
    assert np.abs(y.numpy() - yj).max() < 2e-3
    _, yu = fm.step(fm.init_for(torch.as_tensor(x)), torch.as_tensor(x))
    assert np.abs(y.numpy() - yu.numpy()).max() < 2e-3
    assert np.abs(yu.numpy()).max() > 0.1


def test_sharded_fm_receiver_long_matches_unsharded():
    """A length where a raw float32 f k ramp would quantize (both NCOs use
    the host-float64 wrapped ramp), N = 2^14."""
    cfg = FmReceiverConfig(channel_freq=0.22, decim=4, deviation=0.05)
    m = make_mesh(chan=2, time=4, devices=CPU8)
    N = 1 << 14
    kk = np.arange(N, dtype=np.float64)
    mchirp = np.cumsum(0.03 * np.sin(2 * np.pi * 0.001 * kk))
    ph = 2 * np.pi * (np.mod(0.22 * kk, 1.0) + 0.05 * mchirp)
    x = torch.as_tensor(np.tile(np.exp(1j * ph).astype(np.complex64), (4, 1)))
    fm = FmReceiver.create(cfg, device="cpu")
    y_sh = sharded_fm_receiver(m, fm, x)
    _, y_un = fm.step(fm.init_for(x), x)
    assert np.abs(y_sh[:, 16:].numpy() - y_un[:, 16:].numpy()).max() < 1e-4


def test_sharded_frame_receiver_matches_unsharded():
    """The frame receiver over a chan-sharded mesh (tests/test_parallel.py:
    369-421): each shard's channel decoded alone equals the unsharded
    batched run, and every payload is found."""
    from libtsd_tpu_torch.models import waveform as WF
    from libtsd_tpu_torch.models.detector import DetectorConfig
    from libtsd_tpu_torch.models.frame import (FrameFormat, Receiver,
                                               Transmitter)
    from libtsd_tpu_torch.models.modulator import ModConfig
    rng = np.random.default_rng(42)
    m = make_mesh(chan=4, time=1, devices=CPU8)
    C, n = 4, 6144
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25), device="cpu")
    fmt = FrameFormat(modulation=ModConfig(wf=wf, fe=4.0, fsymb=1.0),
                      header_bits=tuple(int(b) for b in
                                        rng.integers(0, 2, 64)),
                      payload_bits=128)
    tx = Transmitter.create(fmt, device="cpu")
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5), device="cpu")
    pays = torch.as_tensor(rng.integers(0, 2, (C, 128)), dtype=torch.int8)
    frames = tx.transmit(pays).numpy()
    x = (0.01 * (rng.standard_normal((C, n))
                 + 1j * rng.standard_normal((C, n)))).astype(np.complex64)
    for c in range(C):
        x[c, 700 + 50 * c:700 + 50 * c + frames.shape[1]] += \
            0.9 * np.exp(1j * 0.3) * frames[c]
    un = rx.receive(torch.as_tensor(x))
    grid = shard(m, torch.as_tensor(x))
    for c, row in enumerate(grid):
        fr = rx.receive(row[0])
        assert torch.equal(fr.valid, un.valid[c:c + 1])
        assert torch.equal(fr.bits, un.bits[c:c + 1])
        i = int(torch.argmax(un.valid[c].to(torch.int8)))
        assert torch.equal(un.bits[c, i].to(torch.int8), pays[c])


# ------------------------------------------------- launch, two processes

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from libtsd_tpu_torch.ops import fir_design as FD
from libtsd_tpu_torch.ops.filter_rt import fir_toeplitz_mats
from libtsd_tpu_torch.parallel import launch, make_mesh
from libtsd_tpu_torch.parallel import sharded_fir_periodogram4096

addr, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
launch.initialize(addr, nproc, pid)
launch.initialize(addr, nproc, pid)      # idempotent
assert launch.is_distributed()
mesh = make_mesh(chan=nproc, time=2, devices=["cpu"] * 2)
C, N = 2 * nproc, 2 * 8192
rows = launch.host_slice(mesh, "chan", C)
assert launch.host_slice(mesh, "time", N) == slice(0, N)
local = np.stack([np.random.default_rng(1000 + c).standard_normal(N)
                  for c in range(rows.start, rows.stop)]).astype(np.float32)
x = launch.ingest_local(mesh, local)
G = torch.as_tensor(fir_toeplitz_mats(
    np.asarray(FD.fir_lowpass(128, 0.2), np.float64)).astype(np.float32))
acc = sharded_fir_periodogram4096(mesh, x, G, precision="highest",
                                  halo="fused")
total = acc.double().sum()
dist.all_reduce(total)
print(f"proc {pid}: rows {rows.start}:{rows.stop} CHECKSUM {total.item():.12e}",
      flush=True)
# one "time" row across the processes: each holds its half of the samples
row = make_mesh(chan=1, time=2 * nproc, devices=["cpu"] * 2)
assert row.links[0] is not None and row.links[0].transport == "gloo"
ts = launch.host_slice(row, "time", N)
assert ts == slice(pid * N // nproc, (pid + 1) * N // nproc), ts
xrow = np.stack([np.random.default_rng(1000 + c).standard_normal(N)
                 for c in range(2)]).astype(np.float32)[:, ts]
for halo in ("fused", "ppermute"):
    acc = sharded_fir_periodogram4096(row, launch.ingest_local(row, xrow), G,
                                      precision="highest", halo=halo)
    print(f"proc {pid}: ROW {halo} {acc.double().sum().item():.12e}",
          flush=True)
dist.destroy_process_group()
"""


def test_launch_two_processes():
    """initialize -> host_slice / ingest_local -> the sharded chain's plain
    path -> all_reduce'd checksum, in two gloo processes on localhost,
    against the same chain in this process (examples/multihost_demo.py's
    layout: processes on "chan", two shards each on "time"); then one
    "time" row across both processes, in both halo forms, against the same
    chain in this process."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, **THREAD_ENV, "PYTHONPATH": REPO
           + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, f"127.0.0.1:{port}", "2", str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for p in range(2)]
    outs = []
    deadline = time.monotonic() + 120     # both workers, not each
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    sums = [float(o.split("CHECKSUM")[1].split()[0]) for o in outs]
    assert "rows 0:2" in outs[0] and "rows 2:4" in outs[1]
    N = 2 * 8192
    x = np.stack([np.random.default_rng(1000 + c).standard_normal(N)
                  for c in range(4)]).astype(np.float32)
    G = t32(FR.fir_toeplitz_mats(np.asarray(FD.fir_lowpass(128, 0.2),
                                            np.float64)))
    ref = KC.fir_periodogram4096(t32(x), G).double().sum().item()
    for v in sums:
        assert abs(v - ref) / abs(ref) < 1e-5
    # the time row across both processes runs, and each rank holds the
    # row's spectrum: that of the same chain in one process
    ref = KC.fir_periodogram4096(t32(x[:2]), G).double().sum().item()
    for out in outs:
        for halo in ("fused", "ppermute"):
            v = float(out.split(f"ROW {halo}")[1].split()[0])
            assert abs(v - ref) / abs(ref) < 1e-5, (halo, v, ref)
    assert launch.is_distributed() is False
