"""Telecom models of the port: waveforms, modulator, carrier and clock
recovery, the demodulators, BER tooling, the pattern detector, the frame
transmitter and receiver, the analog modems, the FM and QAM-16
receivers, the RDS decoder and the polyphase channelizer."""
from . import (analog, ber, bitstream, carrier_rec,  # noqa: F401
               channelizer, clock_rec, clock_rec2, demod, demod_dec,
               demod_dec2, demod_sb, detector, frame, modulator, rds,
               receivers, waveform)
