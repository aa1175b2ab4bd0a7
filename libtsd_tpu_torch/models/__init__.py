"""Telecom models of the port: waveforms, modulator, carrier and clock
recovery, the decision-directed demodulators, BER tooling, the pattern
detector and the frame transmitter and receiver."""
from . import (ber, bitstream, carrier_rec, clock_rec, demod,  # noqa: F401
               demod_dec, demod_sb, detector, frame, modulator, waveform)
