"""Prompt tokens of every request completed, over the whole window: from
its opening to the last completion."""


def read(run):
    done = sum(s.tokens for s in run.served)
    return done / run.window_end if done and run.window_end > 0 else None
