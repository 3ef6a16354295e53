#!/usr/bin/env python
"""Regenerate docs/api.md — module and public-symbol index."""
import importlib
import inspect
import os
import pkgutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import graphdot_tpu  # noqa: E402


def first_line(doc):
    return (doc or '').strip().split('\n')[0][:92]


def main():
    out = ['# API index', '',
           'Auto-generated module and public-symbol index '
           '(`scripts/gen_api_index.py`).', '']
    mods = ['graphdot_tpu']
    for m in pkgutil.walk_packages(
            graphdot_tpu.__path__, prefix='graphdot_tpu.'):
        mods.append(m.name)
    for name in sorted(set(mods)):
        try:
            mod = importlib.import_module(name)
        except Exception:
            continue
        public = getattr(mod, '__all__', None)
        if public is None:
            public = [
                k for k, v in vars(mod).items()
                if not k.startswith('_')
                and getattr(v, '__module__', None) == name
                and (inspect.isclass(v) or inspect.isfunction(v))
            ]
        if not public and name.count('.') > 1:
            continue
        out.append(f'## `{name}`')
        out.append('')
        head = first_line(mod.__doc__)
        if head:
            out.append(head)
            out.append('')
        for sym in sorted(public):
            obj = getattr(mod, sym, None)
            doc = first_line(getattr(obj, '__doc__', ''))
            out.append(f'- `{sym}`' + (f' — {doc}' if doc else ''))
        out.append('')
    with open(os.path.join(ROOT, 'docs', 'api.md'), 'w') as f:
        f.write('\n'.join(out).rstrip() + '\n')
    print(f'{len(out)} lines written')


if __name__ == '__main__':
    main()
