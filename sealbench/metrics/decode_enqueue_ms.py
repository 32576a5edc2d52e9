"""Dispatch: time in `serve.step.decode_tick`, which returns before the
device finishes, in ms over its count in the window: the host's cost of
enqueueing a decode tick."""


def read(run):
    total = run.spans.get("step.decode_tick")
    if not total or not total[1]:
        return None
    return 1e3 * total[0] / total[1]
