"""Web GUI — replacement for the reference's PyQt4 app
(src/gui/gui.py). See server.py for the endpoint map."""

from .server import GuiApp, make_server, main

__all__ = ["GuiApp", "make_server", "main"]
