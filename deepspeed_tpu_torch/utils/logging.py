"""Framework logger (copy of deepspeed_tpu/utils/logging.py's logger;
the rank filter `log_dist` comes with the distributed slice)."""

import logging
import sys


class LoggerFactory:
    @staticmethod
    def create_logger(name=None, level=logging.INFO):
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = LoggerFactory.create_logger(name="DeepSpeedTPUTorch",
                                     level=logging.INFO)
