"""The harness of the port's benchmark: the parts every cell shares.

``layout`` finds a cell's configuration, traffic mix, driver and metric
readers by the names in ``BENCHMARK.json``; ``inputs`` makes the layers a
configuration deploys; ``program`` builds or loads the served program
from the set-up cache; ``traffic`` is the generator the drivers read
their mixes with; ``spans`` and ``trace`` record what a traced run reads;
``roofline`` holds the card's peaks and the kernels' operation and byte
counts, ``readers`` the reductions the metric readers share; ``judge``
compares the served bits with ``bench/reference``; ``swap`` puts the
control or a planted fault in the timed path's place (tools and tests
only); ``harness`` runs one cell and prints its result line.
"""
