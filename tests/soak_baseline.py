"""The cut that holds a soak record to the committed
``benchmarks/BENCH_scale_baseline.json`` (not a test module). Free of JAX:
the CPU tests and ``chip_smoke.py`` on the card both use it."""

# The fields the reference's soak records gained after the committed
# baseline was written (its event-driven dataplane added them).
ADDED_SINCE_BASELINE = {("fleet_spec", "device_speeds"),
                        ("metrics", "per_device_steps")}


def on_baseline_fields(record, committed):
    """``record`` cut to the keys of the committed record ``committed``,
    after requiring that the keys it has beyond them are exactly
    ``ADDED_SINCE_BASELINE`` (AssertionError otherwise). Values are left
    as they are."""
    extra = {(part, key) for part in record if isinstance(record[part], dict)
             and isinstance(committed.get(part), dict)
             for key in record[part] if key not in committed[part]}
    extra |= {(key,) for key in record if key not in committed}
    if extra != ADDED_SINCE_BASELINE:
        raise AssertionError(
            f"soak record fields beyond the baseline's: {sorted(extra)}")
    return {part: ({k: v for k, v in record[part].items()
                    if k in committed[part]}
                   if isinstance(record[part], dict) else record[part])
            for part in committed}
