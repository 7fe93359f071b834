"""flash_attention_roofline.train: the least time of the flash attention
calls in the traced slice, by the frozen yardstick, over the device time
of the flash kernels."""

from bench import readers, yardstick


def read(run):
    calls = run.data["spans"].records.get("flash", [])
    least = sum(yardstick.least_seconds(yardstick.flash_attention(q, kv, c, el),
                                        run.config["dtype"])
                for q, kv, c, el in calls)
    device_s = readers.kernel_seconds(run, "flash_")
    return readers.share(least, device_s) if least > 0 else None
