"""Prefix cache: prompt tokens the cache held at admission, over the
prompt tokens of the new requests admitted in the window (the collector's
per-request ``cached_prompt_tokens``). Requests already under way when the
window opens are left out: their cached tokens are the warm start's."""


def read(run):
    new = [c for c in run.window.clients
           if not c.req.resumed and c.submit_t <= run.window.t1]
    total = sum(len(c.req.prompt) for c in new)
    return 100.0 * sum(c.cached for c in new) / total if total else None
