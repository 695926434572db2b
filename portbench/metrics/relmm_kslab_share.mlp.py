"""The share of the pass's ``relational_matmul`` calls that took the
long-segment schedule ``kslab``: the program's counters ``relmm.kslab``
over ``relmm.calls`` (one each a call on the card).  Eqs. 10 and 11 at
60,000 rows take it, 2 of a relational pass's 5 calls; none where the
program has no such counter."""
from portbench import program_spans

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "mlp_rows_per_s"


def read(obs, name):
    return program_spans.counter_share("relmm.kslab", "relmm.calls",
                                       "nn2sql.iteration")
