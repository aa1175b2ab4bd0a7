"""models.demod_sb.outputs_ms (ms): host time a QAM step spends in the
port's ``tsd.demod_sb.outputs`` span, per step of the traced window: the
decisions unpacked to bits (``symbol_indices_to_bits``) and the valid
flags repeated a bit.  None on a port without the span."""


def read(tr):
    host, count = tr.span_seconds("tsd.demod_sb.outputs")
    if count == 0 or tr.steps == 0:
        return None
    return 1e3 * host / tr.steps
