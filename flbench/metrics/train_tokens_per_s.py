"""All pods' tokens of every round finished in the window, over the
window's wall time (host clock; the window closes with the round in
flight, synchronised)."""


def read(run):
    if run.rounds == 0 or run.window_s <= 0:
        return None
    return run.tokens_per_round * run.rounds / run.window_s
