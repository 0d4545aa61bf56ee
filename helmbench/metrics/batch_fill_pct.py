"""The chosen batch's fill of the card's cluster slots, from the batch
layer's own table (`batching.predicted_cost_per_vector`), in %."""


def read(run, name):
    fill = run.program.get("fill")
    return None if fill is None else 100.0 * fill
