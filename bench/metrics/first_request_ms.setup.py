"""first_request_ms.setup: the wall time of set-up's first request
(the store load, launch records, upload and first launch; for a stack,
its compile), ms."""


def read(run):
    f = run.first_request_s
    return None if f is None else f * 1e3
