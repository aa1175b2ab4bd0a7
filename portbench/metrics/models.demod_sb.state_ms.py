"""models.demod_sb.state_ms (ms): host time a QAM step spends handling the
state around kernel #6, per step of the traced window: the port's
``tsd.demod_sb.pack_state`` span (the nine-row stack) plus
``tsd.demod_sb.carry`` (the rows unpacked, the power EMA, the input
tail's copy).  The cell's rate follows the host, so this is what the
phase costs a step; None on a port without these spans."""


def read(tr):
    pack, n_pack = tr.span_seconds("tsd.demod_sb.pack_state")
    carry, n_carry = tr.span_seconds("tsd.demod_sb.carry")
    if n_pack == 0 or n_carry == 0 or tr.steps == 0:
        return None
    return 1e3 * (pack + carry) / tr.steps
