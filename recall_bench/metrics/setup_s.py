"""Process start to the window's first instant: imports, the corpus, the
engine's build (the host mirrors and the card's planes), kernel builds on a
cell's first run, the warm-up batches and the clients' ramp."""


def read(run):
    return run.setup_s
