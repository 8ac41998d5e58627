"""iter_ms.decode: mean host ms of one ServingGateway.step() in a decode cell."""
from bench.readers import iter_ms as read  # noqa: F401
