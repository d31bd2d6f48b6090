"""What the shared tests need of the cells added after
``stereobench/conftest.py``, set before any test module is imported:
pytest loads the conftest of each ``test*`` directory under the path it
is given at start-up (``python -m pytest stereobench/tests``), and
collects this directory before ``test_stereobench_faults.py``, which
lists its cases while it is imported.

  * the tiny CPU size of ``middlebury2014_train``, beside
    ``tests/tiny.py``'s;
  * ``tools/calibrate.py``'s control and faults for the cells whose loop
    ``tools/calibrate_train.py`` calibrates (``calibrate.py`` knows the
    ``train`` loop and the map loops only), so that the shared control and
    fault tests hold those cells to their own.
"""

from stereobench.tests import tiny
from stereobench.tools import calibrate_train

tiny.SIZES.setdefault("middlebury2014_train", dict(
    height=24, width=40, num_disparities=10, kernel_size=5,
    frames_per_call=4, scene=dict(tiny.SCENE, d_min=2.0, d_max=8.0)))


calibrate_train.route()
