"""``python -m hmsc_tpu_torch <command>``: ``serve <artifact>`` serves a
compacted posterior over HTTP on the card."""

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "serve":
        sys.stderr.write("usage: python -m hmsc_tpu_torch serve <artifact> "
                         "[options]\n")
        return 2
    from .serve.http import serve_main
    return serve_main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
