"""The repository's bench circuit (bench.py::_bench_circuit,
chip_smoke.py::bench_circuit): a chain of multiplication gates that fills
the domain up to `mul_gates_below_n` gates short of n = 2^k, a range check
of the input x, and an XOR and an AND of x with the chain's last value.

Written against the composer's methods alone and importing nothing, so that
the program's composer and the reference's frozen copy both synthesize it.
"""


def build(params: dict):
    """The circuit class for `params` (k, mul_gates_below_n, range_bits,
    logic_bits).  Its one input is x, below input_bounds(params)["x"]."""
    n_mul = max(1, (1 << params["k"]) - params["mul_gates_below_n"])
    range_bits = params["range_bits"]
    logic_bits = params["logic_bits"]

    class BenchChain:
        def __init__(self, x=3):
            self.x = x

        def synthesize(self, c):
            w = c.append_witness(self.x)
            acc = c.append_witness(1)
            acc = c.append_mul_chain(acc, w, n_mul)
            c.component_range(w, range_bits)
            c.append_logic_xor(w, acc, logic_bits)
            c.append_logic_and(w, acc, logic_bits)

    return BenchChain


def input_bounds(params: dict) -> dict:
    """Each input's exclusive upper bound: x passes the range check."""
    return {"x": 1 << params["range_bits"]}
