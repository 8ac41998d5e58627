"""prefill_ms.chat: mean device ms of one admission's prefill replay plus its splice."""
from bench import program

program.install()
read = program.prefill_ms
