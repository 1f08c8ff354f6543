"""Shared example plumbing: repo path, argparse defaults, plotting toggle."""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import jax


def setup(description, cpu=False, x64=False, **extra_args):
    """Standard example CLI: --seed, --plot, --cpu plus extras.
    Extras: name -> (type, default, help)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('--seed', type=int, default=1337)
    parser.add_argument('--plot', action='store_true',
                        help='save a PNG next to the script')
    parser.add_argument('--cpu', action='store_true', default=cpu)
    parser.add_argument('--x64', action='store_true', default=x64)
    for name, (typ, default, hlp) in extra_args.items():
        if typ is bool:
            parser.add_argument(f'--{name}', action='store_true',
                                default=default, help=hlp)
        else:
            parser.add_argument(f'--{name}', type=typ, default=default,
                                help=hlp)
    args = parser.parse_args()
    if args.cpu:
        jax.config.update('jax_platforms', 'cpu')
    if args.x64:
        jax.config.update('jax_enable_x64', True)
    from mimo_tpu.utils.cache import use_compile_cache
    use_compile_cache()
    return args


def maybe_save_plot(args, name):
    if args.plot:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        out = os.path.join(os.path.dirname(__file__), f'{name}.png')
        plt.savefig(out, dpi=120, bbox_inches='tight')
        print(f'saved {out}')
