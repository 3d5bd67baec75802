"""Mean iterations a lane took, over every lane of the window: the
reports' ``iter``."""


def read(run):
    its = [i for c in run.window for i in c.iters]
    return sum(its) / len(its)
