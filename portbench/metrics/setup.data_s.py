"""harness: seeded inputs. The seconds the resident traffic's set-up took
to make the seeded planes on the card and the flat-field and dark frame,
and to put the fields there (its span ``setup.data``, ending in a
synchronize). Part of ``setup_s``."""


def read(run):
    return run.spans.seconds("setup.data")
