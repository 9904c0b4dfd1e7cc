"""Command-line entry point for vilma-tpu-torch.

The same four subcommands as vilma_tpu.frontend and the shared
--logfile/--verbose flags; each subcommand adds --device {cuda,cpu}.
"""
import argparse
import logging
import sys
from importlib import import_module

from vilma_tpu_torch import VERSION

SUBCOMMANDS = ('make_ld_schema', 'check_ld_schema', 'sim', 'fit')


def _attach_shared_flags(parser):
    parser.add_argument(
        '--logfile', required=False, type=str, default='',
        help='File to store information about the run. To print to '
             'stdout use "-". Defaults to no logging.')
    parser.add_argument(
        '--verbose', dest='verbose', action='store_true',
        help='Log all information (as opposed to just warnings)')


def build_parser():
    """The full CLI parser plus a name -> main-function dispatch map."""
    parser = argparse.ArgumentParser(
        description='vilma-tpu-torch v%s uses variational inference to '
                    'estimate variant effect sizes from GWAS summary data '
                    'while learning the overall distribution of effects, '
                    'on PyTorch with CUDA kernels.' % VERSION,
        usage='vilma-tpu-torch <command> <options>')
    subparsers = parser.add_subparsers(title='Commands', dest='command')
    dispatch = {}
    for name in SUBCOMMANDS:
        module = import_module('vilma_tpu_torch.commands.' + name)
        _attach_shared_flags(module.args(subparsers))
        dispatch[name] = module.main
    return parser, dispatch


def _start_logging(logfile, verbose):
    """--verbose selects DEBUG over WARNING; --logfile '-' logs to the
    console, a path to that file, empty disables logging."""
    level = logging.DEBUG if verbose else logging.WARNING
    if logfile == '-':
        logging.basicConfig(level=level)
    elif logfile:
        logging.basicConfig(filename=logfile, level=level)


def main(argv=None):
    parser, dispatch = build_parser()
    args = parser.parse_args(argv)
    run = dispatch.get(args.command)
    if run is None:
        parser.print_help()
        sys.exit(0)
    _start_logging(getattr(args, 'logfile', ''),
                   getattr(args, 'verbose', False))
    run(args)


if __name__ == '__main__':
    main()
