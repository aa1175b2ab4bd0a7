"""The port's RDS encoder and decoder (models.rds) against the JAX
package on the same numpy inputs, on the CPU.

Tolerances: the code tables, encoders and bit streams bit for bit;
decoded groups (blocks, corrected-bit counts, version flags) and the
assembled strings exactly; float32 signals (the subcarrier, the decoder's
baseband) within 1e-5 of the JAX output's peak (both sides fp32, other
summation orders).
The loopbacks are tests/test_rds.py's at a test size (the multiplex: the
8 groups once and two again, for the PS name and the radiotext; the IF:
three groups), as the pilot PLL's per-sample loop costs the port ~55 us
a sample on one CPU thread."""
import jax.numpy as jnp
import numpy as np
import torch

from libtsd_tpu.models import rds as Rj
from libtsd_tpu.models.analog import fm_broadcast_multiplex as mpx_j
from libtsd_tpu.ops.signal import cycles as cycles_j
from libtsd_tpu_torch.models import rds as Rt
from torch_compare import rel

TOL = 1e-5
PS, RT = "TSD TPU!", "TPU NATIVE DSP! "


def _groups(R):
    pi, pty = 0xF201, 4
    groups = [R.rds_group_0a(pi, pty, s, PS[2 * s:2 * s + 2])
              for s in range(4)]
    groups += [R.rds_group_2a(pi, pty, a, RT[4 * a:4 * a + 4])
               for a in range(4)]
    return pi, groups


def _on_air(R):
    """The 8 groups once, then the first two again: block sync loses the
    first group, whose PS segment comes back at the end."""
    pi, groups = _groups(R)
    return pi, R.rds_encode_groups(groups + groups[:2])


def _same_groups(gt, gj):
    assert len(gt) == len(gj)
    for a, b in zip(gt, gj):
        assert (a.blocks, a.errors, a.version_b) == \
            (b.blocks, b.errors, b.version_b)


# ------------------------------------------------------------ RDS, host

def test_rds_code_tables_and_encoders_bit_for_bit():
    assert np.array_equal(Rt._HT, Rj._HT)
    assert Rt._BURST == Rj._BURST and Rt._OFFSET_SYND == Rj._OFFSET_SYND
    assert Rt.OFFSET_WORDS == Rj.OFFSET_WORDS
    rng = np.random.default_rng(0)
    for m in rng.integers(0, 1 << 16, 40):
        m = int(m)
        assert Rt.rds_checkword(m) == Rj.rds_checkword(m)
        for off in Rt.OFFSET_WORDS:
            assert Rt.rds_encode_block(m, off) == Rj.rds_encode_block(m, off)
    _, gt = _groups(Rt)
    _, gj = _groups(Rj)
    assert gt == gj
    vb = [(0xF201, (1 << 11) | 5, 0xF201, 0x4142)]     # a version-B group
    bt, bj = Rt.rds_encode_groups(gt + vb), Rj.rds_encode_groups(gj + vb)
    assert bt.dtype == bj.dtype and np.array_equal(bt, bj)


def test_rds_host_decoder_matches_jax():
    """The bit-domain half on the same soft baseband, with bursts in it."""
    _, groups = _groups(Rt)
    bits = Rt.rds_encode_groups(groups * 2)
    d = np.bitwise_xor.accumulate(bits)
    sym = np.repeat(1.0 - 2.0 * d, Rt._OSF)
    half = np.tile(np.r_[np.ones(8), -np.ones(8)], len(bits))
    y = sym * half + 0.3 * np.random.default_rng(1).standard_normal(
        len(sym))
    bad = Rt.rds_decode_baseband(y)
    _same_groups(bad, Rj.rds_decode_baseband(y))
    assert Rt.rds_station_name(bad) == Rj.rds_station_name(bad)
    assert Rt.rds_radiotext(bad) == Rj.rds_radiotext(bad)
    b2 = bits.copy()
    b2[104 + 52 + 7:104 + 52 + 10] ^= np.uint8(1)
    st, gt = Rt._sync_and_decode(b2)
    sj, gj = Rj._sync_and_decode(b2)
    assert st == sj
    _same_groups(gt, gj)
    assert gt[1].errors[2] == 3


def test_rds_subcarrier_matches_jax():
    fs = 1.024e6 / 7
    _, groups = _groups(Rt)
    bits = Rt.rds_encode_groups(groups[:2])
    n = 24000
    st = Rt.rds_subcarrier(bits, fs, n, device="cpu")
    sj = Rj.rds_subcarrier(bits, fs, n)
    assert st.shape == (n,) and rel(st, sj) < TOL


# --------------------------------------------------------- RDS loopbacks

def test_rds_mpx_loopback_matches_jax():
    """tests/test_rds.py::test_mpx_loopback's multiplex, the 8 groups once:
    the same multiplex fed to both decoders."""
    fs = 1.024e6 / 7
    pi, bits = _on_air(Rj)
    n = int(len(bits) / Rj._BITRATE * fs) + 4096
    mpx = np.array(0.1 * jnp.cos(2 * jnp.pi * cycles_j(19e3 / fs, n))
                   + Rj.rds_subcarrier(bits, fs, n))
    yj = Rj.rds_baseband(jnp.asarray(mpx), fs)
    yt = Rt.rds_baseband(torch.as_tensor(mpx), fs)
    assert yt.shape == tuple(yj.shape)
    assert rel(yt, yj) < TOL
    # rds_decode_mpx is this composition (the IF test runs it whole)
    gj = Rj.rds_decode_baseband(np.asarray(yj, np.float64))
    gt = Rt.rds_decode_baseband(yt.numpy().astype(np.float64))
    _same_groups(gt, gj)
    assert sum(1 for g in gt if g.errors[0] == 0 and g.pi == pi) >= 7
    assert Rt.rds_station_name(gt) == PS
    assert Rt.rds_radiotext(gt) == RT.rstrip()


def test_rds_if_loopback_matches_jax():
    """tests/test_rds.py::test_fm_if_loopback's IF at 1.024 MHz (stereo
    tones plus RDS through the broadcast front end), three PS groups: the
    decoded groups equal JAX's (the MPX test reads the strings back)."""
    fe = 1.024e6
    pi, groups = _groups(Rj)
    bits = Rj.rds_encode_groups(groups[:3])
    n = int(len(bits) / Rj._BITRATE * fe) + 65536
    al = 0.3 * jnp.sin(2 * jnp.pi * cycles_j(440.0 / fe, n))
    ar = 0.3 * jnp.sin(2 * jnp.pi * cycles_j(1000.0 / fe, n))
    x = np.array(mpx_j(al, ar, fe, rds=Rj.rds_subcarrier(bits, fe, n)))
    gj = Rj.rds_decode(jnp.asarray(x), fe)
    gt = Rt.rds_decode(torch.as_tensor(x), fe)
    _same_groups(gt, gj)
    assert any(g.pi == pi and max(g.errors) == 0 for g in gt)
