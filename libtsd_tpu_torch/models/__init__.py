"""Telecom models of the port: waveforms, modulator, carrier and clock
recovery, the demodulators, BER tooling, the pattern detector, the frame
transmitter and receiver, the analog modems, the FM and QAM-16
receivers, the RDS decoder, the polyphase channelizer, the channel
models, PRBS and spreading codes, SNR estimators, equalizers, statistics
and DOA, Kalman/EKF and IMU filters, and the ADS-B and POCSAG decoders."""
from . import (adsb, analog, ber, bitstream, carrier_rec, channel,  # noqa: F401
               channelizer, clock_rec, clock_rec2, demod, demod_dec,
               demod_dec2, demod_sb, detector, doa, equalizer, frame, imu,
               kalman, lfsr, modulator, pocsag, rds, receivers, snr, spread,
               stats, waveform)
