"""host_gap_ms.decode: median device ms between decode replays of consecutive decode-only steps."""
from bench import program

program.install()
read = program.host_gap_ms
