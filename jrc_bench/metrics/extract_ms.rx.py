"""Device ms a call of the rx stage ``extract`` (both K3 gathers, the LTF
correlation and the peak-pair search): the program's stage clock inside the
captured call, median over its calls."""
from jrc_bench.drivers import program_counters as pc


def read(obs):
    return pc.stage_ms("rx", "extract")
