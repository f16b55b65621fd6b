"""The training log: INFO level, ``'%(asctime)s: %(message)s'``, to the
console and to ``{result_dir}/train.log`` (opened in mode 'w'), as the
reference's logger writes it. In a process group, only rank 0 logs at INFO
and owns the file; the other ranks print warnings and errors."""

from __future__ import annotations

import logging
import os

import torch.distributed as dist


def get_logger(result_dir: str, name: str = "klab_mmm_torch") -> logging.Logger:
    main = not dist.is_initialized() or dist.get_rank() == 0
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if main else logging.WARNING)
    logger.propagate = False
    formatter = logging.Formatter("%(asctime)s: %(message)s")

    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setLevel(logging.INFO)
        sh.setFormatter(formatter)
        logger.addHandler(sh)

    if not main:
        return logger
    # Re-point the file handler when result_dir changes: two train() calls
    # in one process each get their own {result_dir}/train.log; the same
    # directory again keeps its handler and its file.
    log_path = os.path.abspath(os.path.join(result_dir, "train.log"))
    file_handlers = [h for h in logger.handlers
                     if isinstance(h, logging.FileHandler)]
    if not any(os.path.abspath(h.baseFilename) == log_path
               for h in file_handlers):
        for h in file_handlers:
            logger.removeHandler(h)
            h.close()
        os.makedirs(result_dir, exist_ok=True)
        fh = logging.FileHandler(log_path, mode="w")
        fh.setLevel(logging.INFO)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger
