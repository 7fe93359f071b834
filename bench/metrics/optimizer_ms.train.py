"""optimizer_ms.train: device milliseconds inside the AdamW update
(``adamw_update``) a step, in the traced slice."""


def read(run):
    n = run.slice.span_calls.get("optimizer", 0)
    return 1e3 * run.slice.span_s["optimizer"] / n if n else None
