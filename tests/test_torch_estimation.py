"""The port's estimation models (models.stats, models.doa, models.kalman,
models.imu) and geometry (utils.geometry) against the JAX package on the
same numpy inputs, on the CPU.

Tolerances: the host float64 copies (Levinson, LPC, Wiener, MDL, the
steady-state gain) within 1e-12 and the source counts exactly; covmtx,
r2R and the covariance helpers within 1e-5 of the peak; the MUSIC
spectrum's noise-subspace projection sum |a^H v|^2 within 1e-5 of its peak
and the dB spectra's peak bin equal (the spectrum itself is that
projection's reciprocal, which amplifies float32 eigenvector noise near a
peak); the Capon spectra within 1e-4 of the peak, DOA angles equal on the
grid; the Kalman, EKF and IMU filters on the same numpy observations
within 1e-5 of each state component's peak; geometry within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import doa as Dj
from libtsd_tpu.models import imu as Ij
from libtsd_tpu.models import kalman as Kj
from libtsd_tpu.models import stats as Sj
from libtsd_tpu.utils import geometry as Gj
from libtsd_tpu_torch.models import doa as Dt
from libtsd_tpu_torch.models import imu as It
from libtsd_tpu_torch.models import kalman as Kt
from libtsd_tpu_torch.models import stats as St
from libtsd_tpu_torch.utils import convert
from libtsd_tpu_torch.utils import geometry as Gt
from torch_compare import rel

CPU = "cpu"
TOL = 1e-5


def _cn(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _tones(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    return (np.exp(2j * np.pi * 0.1 * k) + 0.5 * np.exp(-2j * np.pi * 0.23 * k)
            + 0.3 * _cn(rng, n)).astype(np.complex64)


# ------------------------------------------------------------ stats, host

def test_levinson_lpc_wiener_host_copies():
    rng = np.random.default_rng(1)
    r = np.array([1.0, 0.5, 0.2, 0.05, -0.01, 0.003])
    assert np.abs(St.levinson_real(r) - Sj.levinson_real(r)).max() < 1e-12
    assert np.array_equal(St.levinson_real(r[:1]), Sj.levinson_real(r[:1]))
    l1 = np.array([4.0, 1.0, 0.5, 0.2])
    c1 = np.array([4.0, -0.7, 0.3, 0.1])
    y = rng.standard_normal(4)
    assert np.abs(St.levinson(l1, c1, y) - Sj.levinson(l1, c1, y)).max() \
        < 1e-12
    with pytest.raises(ValueError):
        St.levinson(l1, c1 * 2, y)
    x = np.convolve(rng.standard_normal(3000), [1, -0.9, 0.4])
    at, et = St.lpc(torch.as_tensor(x), 6)
    aj, ej = Sj.lpc(x, 6)
    assert np.abs(at - aj).max() < 1e-12 and abs(et - ej) < 1e-12
    rxy = rng.standard_normal(4)
    assert np.abs(St.wiener_fir(r, rxy) - Sj.wiener_fir(r, rxy)).max() \
        < 1e-12


@pytest.mark.parametrize("cplx", [False, True])
def test_r2R(cplx):
    rng = np.random.default_rng(2)
    r = (_cn(rng, 3, 9) if cplx
         else rng.standard_normal((3, 9)).astype(np.float32))
    assert rel(St.r2R(torch.as_tensor(r)), np.asarray(Sj.r2R(
        jnp.asarray(r)))) < TOL
    assert rel(St.r2R(r[0], device=CPU), np.asarray(Sj.r2R(r[0]))) < TOL


def test_covmtx_and_mdl():
    x = _tones()
    Rt = St.covmtx(torch.as_tensor(x), 16)
    Rj = np.asarray(Sj.covmtx(jnp.asarray(x), 16))
    assert rel(Rt, Rj) < TOL
    vt, nt = St.mdl_criterion(Rt)
    vj, nj = Sj.mdl_criterion(Rj)
    assert nt == nj and np.abs(vt - vj).max() <= 1e-4 * np.abs(vj).max()
    for n_obs in (None, 2048):
        ct, kt = St.mdl_source_count(Rt, n_obs)
        cj, kj = Sj.mdl_source_count(Rj, n_obs)
        assert ct == cj == 2
        assert np.abs(kt - kj).max() <= 1e-4 * np.abs(kj).max()


def _denom(db):
    """The noise-subspace projection sum |a^H v|^2 back from a MUSIC
    spectrum in dB."""
    return 10 ** (-np.asarray(db, np.float64) / 10)


@pytest.mark.parametrize("Ns", [2, -1])
def test_psd_subspace(Ns):
    x = _tones()
    gt, st = St.psd_subspace(torch.as_tensor(x), Ns, 512, 16)
    gj, sj = Sj.psd_subspace(jnp.asarray(x), Ns, 512, 16)
    assert np.abs(gt.numpy() - np.asarray(gj)).max() < 1e-6
    dt, dj = _denom(st.numpy()), _denom(sj)
    assert np.abs(dt - dj).max() < TOL * dj.max()
    assert np.argmax(st.numpy()) == np.argmax(np.asarray(sj))
    # a tone at +0.1 peaks at the mirrored -0.1 (the reference's xcorr
    # conjugation, stats.py covmtx)
    assert abs(float(gt[np.argmax(st.numpy())]) + 0.1) < 2 / 512


def test_subspace_spectrum_custom_steering_and_default_m(tmp_path,
                                                         monkeypatch):
    x = _tones(512, seed=3)
    _, st = St.psd_subspace(torch.as_tensor(x), 2, 256)      # m = 64
    _, sj = Sj.psd_subspace(jnp.asarray(x), 2, 256)
    assert np.abs(_denom(st.numpy()) - _denom(sj)).max() \
        < TOL * _denom(sj).max()
    R = np.asarray(Sj.covmtx(jnp.asarray(x), 8))

    def steer_t(f, m):
        return torch.exp(2j * np.pi * f * torch.arange(m) * 0.5)

    def steer_j(f, m):
        return jnp.exp(2j * jnp.pi * f * jnp.arange(m) * 0.5)
    _, st = St.subspace_spectrum(torch.as_tensor(R), 2, 64, steering=steer_t)
    _, sj = Sj.subspace_spectrum(R, 2, 64, steering=steer_j)
    assert np.abs(_denom(st.numpy()) - _denom(sj)).max() \
        < TOL * _denom(sj).max()
    # debug=True draws the eigenvalue and MDL figures into viz's report
    from libtsd_tpu_torch.viz import report
    rep = report.Report(str(tmp_path))
    monkeypatch.setattr(report, "_report", rep)
    _, sd = St.subspace_spectrum(R, -1, 64, debug=True, device="cpu")
    assert [i[2] for i in rep._items if i[0] == "fig"] == ["MDL"]
    assert torch.equal(sd, St.subspace_spectrum(R, -1, 64, device="cpu")[1])


# ------------------------------------------------------------ DOA

M, D, L, T = 16, 0.5, 10, 400


def _steer(theta_deg):
    return np.exp(2j * np.pi * D * np.cos(np.deg2rad(theta_deg))
                  * np.arange(M))


def _scene(coherent, seed=11):
    """examples/doa_demo.py's two-source scene at its own size."""
    rng = np.random.default_rng(seed)
    c1 = _cn(rng, T)
    if coherent:
        X = np.outer(_steer(70) + 0.8 * np.exp(1j * 0.7) * _steer(110), c1)
    else:
        X = np.outer(_steer(70), c1) + np.outer(_steer(110), _cn(rng, T))
    X = X + 0.1 * _cn(rng, M, T)
    return (X @ X.conj().T / T).astype(np.complex64)


@pytest.mark.parametrize("coherent", [False, True])
def test_doa_spectra_and_angles(coherent):
    R = _scene(coherent)
    Rt = torch.as_tensor(R)
    Rs_t = Dt.spatial_smoothing(Rt, L)
    Rs_j = np.asarray(Dj.spatial_smoothing(jnp.asarray(R), L))
    assert rel(Rs_t, Rs_j) < TOL
    assert rel(Dt.spatial_smoothing(R, L, backward=False, device=CPU),
               np.asarray(Dj.spatial_smoothing(R, L, backward=False))) < TOL
    for Rx, Rxj in ((Rt, R), (Rs_t, Rs_j)):
        pt, ct = Dt.capon_spectrum(Rx, D, 512)
        pj, cj = Dj.capon_spectrum(jnp.asarray(Rxj), D, 512)
        assert np.abs(pt.numpy() - np.asarray(pj)).max() < 1e-6
        assert rel(ct, np.asarray(cj)) < 1e-4
        for ft, fj in ((Dt.musicdoa_1d, Dj.musicdoa_1d),
                       (Dt.capondoa_1d, Dj.capondoa_1d)):
            at = ft(Rx, D, 2, Nf=2048).numpy()
            aj = np.asarray(fj(jnp.asarray(Rxj), D, 2, Nf=2048))
            assert np.array_equal(at, aj)
    # smoothed MUSIC within 1 degree of both sources (doa_demo.py)
    got = np.sort(np.rad2deg(Dt.musicdoa_1d(Rs_t, D, 2, Nf=2048).numpy()))
    assert np.abs(got - [70, 110]).max() < 1.0
    n_raw = St.mdl_source_count(R, T)[0]
    n_sm = St.mdl_source_count(Rs_t, T)[0]
    assert (n_raw, n_sm) == ((1, 2) if coherent else (2, 2))


def test_doa_peak_pick_ties_and_fillers():
    """The peak pick on spectra with plateaus and with fewer local maxima
    than asked: ties to the lower index, then the zero-score grid points
    in index order, as jax.lax.top_k returns them (doa.py:59)."""
    phis = np.linspace(0, np.pi, 12).astype(np.float32)
    for S in ([0, 1, 3, 3, 1, 0, 2, 2, 0, 5, 4, 4],     # plateaus, 3 peaks
              [1, 2, 3, 4, 5, 6, 5, 4, 3, 2, 1, 0],     # one peak
              [4, 3, 2, 1, 0, 0, 0, 0, 1, 2, 3, 4]):    # both ends
        S = np.asarray(S, np.float32)
        for Ns in (1, 2, 4, 6):
            assert np.array_equal(
                Dt._top_peaks(torch.as_tensor(S), torch.as_tensor(phis),
                              Ns).numpy(),
                np.asarray(Dj._top_peaks(jnp.asarray(S), jnp.asarray(phis),
                                         Ns)))


def test_sensorcov_and_steering():
    pos = 2 * np.pi * D * np.arange(M)
    for deg in ([60.0], [30.0, 100.0]):
        R = np.asarray(Dj.sensorcov_1d(pos, np.deg2rad(deg), 30.0))
        assert rel(Dt.sensorcov_1d(pos, np.deg2rad(deg), 30.0, device=CPU),
                   R) < TOL
        A = Dt.steervec_1d(torch.as_tensor(pos), np.deg2rad(deg))
        assert rel(A, np.asarray(Dj.steervec_1d(pos, np.deg2rad(deg)))) < TOL
    # one source at 60 degrees: MUSIC and Capon find it on the grid
    R = Dt.sensorcov_1d(pos, np.deg2rad([60.0]), 30.0, device=CPU)
    for f in (Dt.musicdoa_1d, Dt.capondoa_1d):
        assert abs(np.rad2deg(float(f(R, D, 1, Nf=1801)[0])) - 60) < 0.1


# ------------------------------------------------------------ Kalman

def _peak_err(a, b):
    """Per state component: max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b).reshape(len(a), -1).max(0)
                  / np.maximum(np.abs(b).reshape(len(b), -1).max(0), 1e-30))


def test_kalman_filter_random_walk_and_2d():
    rng = np.random.default_rng(4)
    ys = (np.cumsum(0.1 * rng.standard_normal(600))
          + rng.standard_normal(600)).astype(np.float32)[:, None]
    ssm_j = Kj.ssm_random_walk(0.01, 1.0)
    xj, Pj = Kj.kalman_filter(ssm_j, jnp.asarray(ys))
    for ssm in (Kt.ssm_random_walk(0.01, 1.0),
                convert.linear_ssm_from_jax(ssm_j)):
        xt, Pt = Kt.kalman_filter(ssm, torch.as_tensor(ys))
        assert _peak_err(xt, xj) < TOL and _peak_err(Pt, Pj) < TOL
    # constant velocity, position and velocity observed (ny = 2: solve_ex)
    dt = 0.1
    ssm2 = dict(A=np.array([[1, dt], [0, 1]]), C=np.eye(2),
                Q=0.01 * np.eye(2), R=np.diag([0.5, 0.2]))
    y2 = rng.standard_normal((300, 2)).astype(np.float32) + np.stack(
        [np.arange(300) * 0.1, np.ones(300)], 1).astype(np.float32)
    xj, Pj = Kj.kalman_filter(Kj.LinearSSM(**ssm2), jnp.asarray(y2),
                              x0=np.zeros(2), P0=np.eye(2))
    xt, Pt = Kt.kalman_filter(Kt.LinearSSM(**ssm2), torch.as_tensor(y2),
                              x0=np.zeros(2), P0=np.eye(2))
    assert _peak_err(xt, xj) < TOL and _peak_err(Pt, Pj) < TOL
    for mk in (Kt.ssm_random_walk, Kt.ssm_constant):
        a = mk()
        b = getattr(Kj, mk.__name__)()
        assert all(np.array_equal(getattr(a, k), getattr(b, k))
                   for k in "ACQR")
        assert np.abs(Kt.kalman_steady_gain(a, 50)
                      - Kj.kalman_steady_gain(b, 50)).max() < 1e-12
    with pytest.raises(ValueError):
        Kt.kalman_steady_gain(Kt.ssm_constant(), 0)


def test_linear_ssm_simulate():
    """Shapes and device; with no noise the trajectory is the model's
    recursion; the noise has the model's covariance."""
    ssm = Kt.LinearSSM(A=np.array([[0.9, 0.1], [0.0, 0.95]]),
                       C=np.array([[1.0, 0.0]]), Q=np.zeros((2, 2)),
                       R=np.zeros((1, 1)))
    xs, ys = ssm.simulate(torch.Generator().manual_seed(0), 50,
                          x0=np.array([1.0, 2.0]))
    assert xs.shape == (50, 2) and ys.shape == (50, 1)
    x = np.array([1.0, 2.0])
    for i in range(50):
        x = ssm.A @ x
        assert np.abs(xs[i].numpy() - x).max() < 1e-5
    rw = Kt.ssm_random_walk(q=0.04, r=0.25)
    xs, ys = rw.simulate(torch.Generator().manual_seed(1), 20000)
    dx = np.diff(xs.numpy()[:, 0])
    assert abs(dx.std() / 0.2 - 1) < 0.03
    assert abs((ys - xs).numpy().std() / 0.5 - 1) < 0.03


def test_ekf_kitagawa_same_observations():
    """Each step from JAX's previous state (x, P) within 1e-5 of JAX's
    next state; the whole 100-step trajectory within 1e-4: this EKF
    linearises y = x^2/20 around its own estimate, and a last-bit
    difference there (torch's and XLA's cos, a float64 tangent) grows
    by ~30x at some steps."""
    rng = np.random.default_rng(5)
    x, ys = 0.1, []
    for i in range(100):
        x = (0.5 * x + 25 * x / (1 + x * x) + 8 * np.cos(1.2 * i)
             + np.sqrt(10) * rng.standard_normal())
        ys.append(x * x / 20 + rng.standard_normal())
    ys = np.asarray(ys, np.float32)
    fj, gj = Kj.kitagawa_model()
    ft, gt = Kt.kitagawa_model()
    Q, R, x0 = np.diag([10.0, 0.0]), np.eye(1), np.array([0.1, 0.0])
    xj, Pj = Kj.ekf_filter(fj, gj, Q, R, jnp.asarray(ys), x0=x0)
    xj, Pj = np.asarray(xj), np.asarray(Pj)
    xt, Pt = Kt.ekf_filter(ft, gt, Q, R, torch.as_tensor(ys), x0=x0)
    assert xt.dtype == torch.float32 and xt.shape == (100, 2)
    assert _peak_err(xt, xj) < 1e-4
    x1, P1 = [], []
    for i in range(100):
        a, b = Kt.ekf_filter(ft, gt, Q, R, torch.as_tensor(ys[i:i + 1]),
                             x0=x0 if i == 0 else xj[i - 1],
                             P0=None if i == 0 else Pj[i - 1])
        x1.append(a[0].numpy())
        P1.append(b[0].numpy())
    assert _peak_err(np.asarray(x1), xj) < TOL
    # P = (I - K G) Pp cancels digits of the prior Pp = F P F^T + Q (~1e4
    # where |F| ~ 25): each step's P within 1e-5 of its prior's peak
    Jf = jax.jacfwd(fj)
    for i in range(1, 100):
        F = np.asarray(Jf(jnp.asarray(xj[i - 1])))
        Pp = F @ Pj[i - 1] @ F.T + Q
        assert np.abs(P1[i] - Pj[i]).max() < TOL * np.abs(Pp).max()


# ------------------------------------------------------------ IMU

def test_imu_ekf_same_observations():
    """JAX's simulated gyro and accel/mag observations through both
    filters; the model's f and g against JAX's too."""
    mj, mt = Ij.ImuModel(), It.ImuModel()
    qs, gyro, obs = Ij.imu_simulate(mj, jax.random.PRNGKey(1), 60)
    gyro, obs = np.array(gyro), np.array(obs)
    qj = np.asarray(Ij.imu_ekf(mj, jnp.asarray(gyro), jnp.asarray(obs)))
    qt = It.imu_ekf(mt, torch.as_tensor(gyro), torch.as_tensor(obs))
    assert _peak_err(qt, qj) < TOL
    q = np.asarray(qs)[7]
    assert rel(mt.f(torch.as_tensor(q), torch.as_tensor(gyro[7])),
               np.asarray(mj.f(jnp.asarray(q), jnp.asarray(gyro[7])))) < 1e-6
    assert rel(mt.g(torch.as_tensor(q)),
               np.asarray(mj.g(jnp.asarray(q)))) < 1e-6


def test_imu_simulate_and_ekf_track_attitude():
    """tests/test_advanced.py:54-64 on the port's own simulation (its
    model, 600 steps): unit quaternions, and the EKF's mean attitude
    distance over the tail under 0.05.  (The file's other gate, EKF error
    under half dead reckoning's at :85, holds on 3 of 12 JAX keys at its
    model: a property of the key, so it is not mirrored here.)"""
    m = It.ImuModel(dt=0.01, gyro_noise=2e-3, accel_noise=0.03,
                    mag_noise=0.03)
    n = 600
    qs, gyro, obs = It.imu_simulate(m, torch.Generator().manual_seed(0), n)
    assert qs.shape == (n, 4) and gyro.shape == (n, 3) \
        and obs.shape == (n, 6)
    assert np.abs(np.linalg.norm(qs.numpy(), axis=1) - 1).max() < 1e-5
    qh = It.imu_ekf(m, gyro, obs).numpy()
    qt = qs.numpy()
    d = np.minimum(np.linalg.norm(qt - qh, axis=1),
                   np.linalg.norm(qt + qh, axis=1))[200:]
    assert d.mean() < 0.05, d.mean()


# ------------------------------------------------------------ geometry

def test_quaternion_ops():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    r = rng.standard_normal((5, 4)).astype(np.float32)
    v = rng.standard_normal((5, 3)).astype(np.float32)
    qn = np.asarray(Gj.quat_normalize(jnp.asarray(q)))
    pairs = [
        (Gt.quat_mult(torch.as_tensor(q), torch.as_tensor(r)),
         Gj.quat_mult(jnp.asarray(q), jnp.asarray(r))),
        (Gt.quat_conj(torch.as_tensor(q)), Gj.quat_conj(jnp.asarray(q))),
        (Gt.quat_normalize(torch.as_tensor(q)), qn),
        (Gt.quat_rotate(torch.as_tensor(qn), torch.as_tensor(v)),
         Gj.quat_rotate(jnp.asarray(qn), jnp.asarray(v))),
        (Gt.quat_from_axis_angle([1.0, 2.0, -0.5], 0.7, device=CPU),
         Gj.quat_from_axis_angle([1.0, 2.0, -0.5], 0.7)),
        (Gt.quat_to_rotmat(torch.as_tensor(qn[0])),
         Gj.quat_to_rotmat(jnp.asarray(qn[0]))),
    ]
    for a, b in pairs:
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-6


@pytest.mark.parametrize("angles", [(0.3, -0.5, 1.2), (np.pi, 0.0, 0.0),
                                    (0.0, 0.0, np.pi), (np.pi, 0.0, np.pi),
                                    (0.1, 1.5, -2.0)])
def test_cardan_rotmat_quaternion(angles):
    """Every Shepperd branch (the 180-degree rotations pick x, y or z)."""
    Rt = Gt.cardan_to_rotmat(*angles, device=CPU)
    Rj = np.asarray(Gj.cardan_to_rotmat(*angles))
    assert np.abs(Rt.numpy() - Rj).max() < 1e-6
    qt = Gt.rotmat_to_quat(Rt)
    qj = np.asarray(Gj.rotmat_to_quat(jnp.asarray(Rj)))
    assert np.abs(qt.numpy() - qj).max() < 1e-6
    assert np.abs(Gt.quat_from_cardan(*angles, device=CPU).numpy()
                  - np.asarray(Gj.quat_from_cardan(*angles))).max() < 1e-6
    for a, b in zip(Gt.rotmat_to_cardan(Rt),
                    Gj.rotmat_to_cardan(jnp.asarray(Rj))):
        assert abs(float(a) - float(b)) < 1e-6
    for a, b in zip(Gt.quat_to_cardan(qt), Gj.quat_to_cardan(
            jnp.asarray(qj))):
        assert abs(float(a) - float(b)) < 1e-6
