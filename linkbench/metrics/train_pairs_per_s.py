"""``train_pairs_per_s``: the candidate pairs of every job in the window
over the seconds from the window's start to the last job's end."""


def read(run):
    if not run.jobs or run.window_s <= 0:
        return None
    return run.pairs_per_job * len(run.jobs) / run.window_s
