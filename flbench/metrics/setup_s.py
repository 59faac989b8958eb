"""Process start to the first timed round: imports, the kernels'
extension, weights from the seed, optimizer state and the first
rounds, which warm every shape.  The seconds spent reading the first
rounds for the check are left out."""


def read(run):
    return run.setup_s
