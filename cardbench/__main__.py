import time

T0 = time.perf_counter()   # process start, as near as Python gets to it

import sys  # noqa: E402

from cardbench.run import main  # noqa: E402

sys.exit(main(sys.argv[1:], t0=T0))
