"""decode_graph_ms.decode: median device ms of one decode-graph replay, from the program's timing events."""
from bench import program

program.install()
read = program.decode_graph_ms
