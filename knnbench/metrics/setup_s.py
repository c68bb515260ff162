"""setup_s (s): process start to the dispatch of the first timed batch:
imports, the inputs made on the card, the program's build (and in a fresh
checkout its nvcc compile), the index's add and build, the warm-up. The
reference's time (a range cell's radius) is left out."""


def read(run):
    return run.setup_s
