"""prefill_useful_share.chat: percent of the prefills' computed positions that their splices wrote."""
from bench import program

program.install()
read = program.prefill_useful_share
