"""Command-line interface: train / test / predict.

Port of ``deeplearning4j_tpu/cli``. Reference: deeplearning4j-cli
(SURVEY §2.6/§3.6) — ``cli/driver/CommandLineInterfaceDriver.java:60``
(subcommand dispatch) and ``subcommands/Train.java:65`` (flags
-conf/-input/-output/-model plus a java-properties config file;
``Test.java``, ``Predict.java``).
"""

from .driver import main

__all__ = ["main"]
