"""The share of the traced scoring slice in which neither a kernel nor a
copy runs on the card."""


def read(r):
    return 100.0 * r.view.idle_share() if r.counts.get("requests") else None
