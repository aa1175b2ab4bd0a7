"""Where the port's entry points put input that is not a tensor.

An array (or a list, or plain numbers) given to a function of the port
goes to ``device``, the card unless the caller names another; without a
card that raises instead of running on the CPU.  ``device="cpu"`` runs it
on the CPU.  A tensor stays where it is (the comparison tests hold the
results to JAX).  No JAX call: the contract is the port's own."""
import numpy as np
import pytest
import torch

import torch_compare  # noqa: F401  (thread caps)
from libtsd_tpu_torch.models import channel as CH
from libtsd_tpu_torch.models import doa as D
from libtsd_tpu_torch.models import kalman as K
from libtsd_tpu_torch.models import lfsr as LF
from libtsd_tpu_torch.models import pocsag as PG
from libtsd_tpu_torch.models import rds as RDS
from libtsd_tpu_torch.models import stats as ST
from libtsd_tpu_torch.models.imu import ImuModel, imu_ekf
from libtsd_tpu_torch.ops.signal import cycles
from libtsd_tpu_torch.utils import geometry as G

_rng = np.random.default_rng(5)
_POS = 2 * np.pi * 0.5 * np.arange(8)
_ANG = np.deg2rad([60.0, 100.0])
_X = (_rng.standard_normal((8, 64))
      + 1j * _rng.standard_normal((8, 64))).astype(np.complex64)
_R = (_X @ _X.conj().T / 64).astype(np.complex64)
_x = (_rng.standard_normal(256)
      + 1j * _rng.standard_normal(256)).astype(np.complex64)
_ys = _rng.standard_normal((20, 1)).astype(np.float32)
_Q = np.asarray([0.3, 0.1, -0.2, 0.9], np.float32)
_Q = _Q / np.linalg.norm(_Q)
_ROT = np.eye(3, dtype=np.float32)
_f, _g = K.kitagawa_model()
_BITS = _rng.integers(0, 2, 104).astype(np.uint8)
# a POCSAG IF (host numpy, as pocsag_waveform makes it) at 38.4 kHz
_POC = PG.pocsag_waveform(PG.pocsag_encode(1234, 3, "OK"), 38400.0, 1200)

CASES = {
    "steervec_1d": lambda **kw: D.steervec_1d(_POS, _ANG, **kw),
    "sensorcov_1d": lambda **kw: D.sensorcov_1d(_POS, _ANG, **kw),
    "spatial_smoothing": lambda **kw: D.spatial_smoothing(_R, 4, **kw),
    "capon_spectrum": lambda **kw: D.capon_spectrum(_R, 0.5, 64, **kw),
    "capondoa_1d": lambda **kw: D.capondoa_1d(_R, 0.5, 1, 64, **kw),
    "musicdoa_1d": lambda **kw: D.musicdoa_1d(_R, 0.5, 1, 64, **kw),
    "r2R": lambda **kw: ST.r2R(_R[0], **kw),
    "covmtx": lambda **kw: ST.covmtx(_x, 8, **kw),
    "subspace_spectrum": lambda **kw: ST.subspace_spectrum(_R, 1, 64, **kw),
    "psd_subspace": lambda **kw: ST.psd_subspace(_x, 1, 64, 8, **kw),
    "prbs_check": lambda **kw: LF.prbs_check(np.ones(64, np.int8), 5, **kw),
    "doppler_psd": lambda **kw: CH.doppler_psd(np.linspace(-60, 60, 9),
                                               50.0, **kw),
    "kalman_filter": lambda **kw: K.kalman_filter(K.ssm_random_walk(), _ys,
                                                  **kw),
    "ekf_filter": lambda **kw: K.ekf_filter(_f, _g, np.eye(2) * 0.1,
                                            np.eye(1), _ys, [0.1, 0.0],
                                            **kw),
    "imu_ekf": lambda **kw: imu_ekf(ImuModel(),
                                    np.zeros((5, 3), np.float32),
                                    np.zeros((5, 6), np.float32), **kw),
    "quat_to_rotmat": lambda **kw: G.quat_to_rotmat(_Q, **kw),
    "rotmat_to_quat": lambda **kw: G.rotmat_to_quat(_ROT, **kw),
    "rotmat_to_cardan": lambda **kw: G.rotmat_to_cardan(_ROT, **kw),
    "quat_to_cardan": lambda **kw: G.quat_to_cardan(_Q, **kw),
    "quat_from_axis_angle": lambda **kw: G.quat_from_axis_angle(
        [1.0, 0.0, 0.0], 0.3, **kw),
    "cardan_to_rotmat": lambda **kw: G.cardan_to_rotmat(0.1, 0.2, 0.3,
                                                        **kw),
    "quat_from_cardan": lambda **kw: G.quat_from_cardan(0.1, 0.2, 0.3,
                                                        **kw),
    # the examples' host-made inputs (protocols_demo): the RDS subcarrier
    # and the tone ramps of the multiplex, a POCSAG IF to the decoder
    "rds_subcarrier": lambda **kw: RDS.rds_subcarrier(_BITS, 1.024e6, 4096,
                                                      **kw),
    "cycles": lambda **kw: cycles(440.0 / 1.024e6, 4096, **kw),
    "pocsag_front": lambda **kw: PG.PocsagDecoder(
        PG.PocsagConfig(), **kw)._front(_POC),
}


def _devices(out):
    """The device types of every tensor in a (nested) result."""
    if isinstance(out, torch.Tensor):
        return {out.device.type}
    if isinstance(out, (tuple, list)):
        return set().union(*(_devices(o) for o in out))
    return set()


@pytest.mark.parametrize("name", sorted(CASES))
def test_array_input_goes_to_the_card(name):
    call = CASES[name]
    if torch.cuda.is_available():
        assert _devices(call()) <= {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert _devices(call(device="cpu")) <= {"cpu"}
