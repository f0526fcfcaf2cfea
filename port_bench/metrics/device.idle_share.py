"""Device layer (the card): the share of the traced stretch's wall time in
which no operation ran on the device: 1 - (union of the device operations'
intervals) / (the stretch's length), both from the same trace."""


def read(data):
    t = data.traced
    if t.seconds <= 0.0:
        return None
    return 1.0 - t.busy_seconds() / t.seconds
