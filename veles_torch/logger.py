"""The ``Logger`` mixin of the port (the reference's ``veles/logger.py``
mixin, without its structured-log sinks): ``self.info`` / ``debug`` /
``warning`` / ``error`` / ``exception`` on a ``logging`` logger named
``veles_torch.<name>``, where ``name`` is the object's ``name`` attribute
or its class name. The port's CLI gives the ``veles_torch`` logger its
handler, so these lines land where the rest of the port's do.
"""

import logging


class Logger:
    """Mixin: self.info/debug/warning/error/exception."""

    @property
    def logger(self) -> logging.Logger:
        cached = self.__dict__.get("_logger")
        name = "veles_torch.%s" % (getattr(self, "name", None)
                                   or type(self).__name__)
        if cached is None or cached.name != name:
            cached = logging.getLogger(name)
            self.__dict__["_logger"] = cached
        return cached

    def debug(self, msg, *args):
        self.logger.debug(msg, *args)

    def info(self, msg, *args):
        self.logger.info(msg, *args)

    def warning(self, msg, *args):
        self.logger.warning(msg, *args)

    def error(self, msg, *args):
        self.logger.error(msg, *args)

    def exception(self, msg, *args):
        self.logger.exception(msg, *args)
