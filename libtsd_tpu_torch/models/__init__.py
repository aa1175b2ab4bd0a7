"""Telecom models of the port: waveforms, modulator, carrier and clock
recovery, the decision-directed demodulators, BER tooling."""
from . import (ber, bitstream, carrier_rec, clock_rec, demod_dec,  # noqa: F401
               demod_sb, modulator, waveform)
