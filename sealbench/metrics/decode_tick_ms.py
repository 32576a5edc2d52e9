"""Dispatch: the decode tick's span (`ServeEngine._decode_tick`, to its
one device-to-host copy) in ms, its total over the window over its count."""


def read(run):
    total = run.spans.get("engine.decode_tick")
    if not total or not total[1]:
        return None
    return 1e3 * total[0] / total[1]
