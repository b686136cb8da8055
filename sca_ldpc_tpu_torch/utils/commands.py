"""Reflection-based subcommand framework (reference: simulate/utils.py:45-96).

Subclasses define ``command_<name>`` methods; the positional ``command``
argument dispatches by prefix.
"""

import argparse
import logging
import sys

logger = logging.getLogger(__name__)


class CommandsBase:
    PREFIX = "command_"

    def __init__(self):
        self._parser = argparse.ArgumentParser()
        possible = sorted(
            name[len(self.PREFIX):] for name in dir(self) if name.startswith(self.PREFIX)
        )
        self._parser.add_argument(
            "command",
            help="What command should execute? Possible values: " + str(possible),
        )
        self._parser.add_argument("--verbose", "-v", action="count", default=0)
        self.setup_arguments(self._parser)

    def setup_arguments(self, parser):
        pass

    def parse_arguments(self, args=None):
        parsed = self._parser.parse_args(args)
        level = logging.DEBUG if parsed.verbose else logging.INFO
        logging.basicConfig(level=level, format="%(asctime)s %(name)s %(levelname)s %(message)s")
        logging.getLogger().setLevel(level)
        return parsed

    def run(self, args):
        func = getattr(self, self.PREFIX + str(args.command), None)
        if func is None:
            logger.error("Bad command given: " + str(args.command))
            sys.exit(1)
        logger.info(f'Executing "{args.command}" with arguments: {args}')
        return func(args)
