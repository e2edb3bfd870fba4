"""A headless, structural stand-in for the PySide6 API slice the GUI uses (port of ``gui/headless_qt.py``).

This is NOT a pixel toolkit: it implements the *behavioral* contract of
the PySide6 classes
``configurable_spectrograms_torch.cli.GUI_batch_download_plot_FAST.run_qt``
touches --
signals with cross-thread queued delivery, an event loop, widget state
(text, checked, properties, stylesheet), layouts with a discoverable
widget tree, tabs/stacks with a current index -- so the Qt front-end
executes end-to-end in environments without Qt or a display (the same
role ``QT_QPA_PLATFORM=offscreen`` plays on a real Qt install).

:func:`install` registers the stub under ``sys.modules['PySide6']`` (and
submodules) unless a real PySide6 is importable; with Qt present the real
modules win and this file is inert.  ``CST_GUI_HEADLESS_QT=1`` asks
``main()`` to install the stub and run the Qt front-end instead of
falling back to the TUI.

Threading model (mirrors Qt's auto-connection semantics): a signal
emitted on the thread that created the ``QApplication`` invokes its slots
immediately; emitted from any other thread it is queued and delivered by
``QApplication.processEvents()`` / the ``exec()`` loop.
"""

from __future__ import annotations

import collections
import importlib.util
import os
import sys
import threading
import time
import types

# ---------------------------------------------------------------------------
# QtCore
# ---------------------------------------------------------------------------


class _BoundSignal:
    def __init__(self, owner, name):
        self._owner = owner
        self._name = name
        self._slots: list = []

    def connect(self, slot) -> None:
        self._slots.append(slot)

    def disconnect(self, slot=None) -> None:
        if slot is None:
            self._slots.clear()
        else:
            self._slots.remove(slot)

    def emit(self, *args) -> None:
        if getattr(self._owner, "_signals_blocked", False):
            return  # QObject.blockSignals(True) swallows emissions, as in Qt
        app = QApplication.instance()
        if app is not None and threading.current_thread() is not app._gui_thread:
            app._post(lambda: self._deliver(*args))
        else:
            self._deliver(*args)

    def _deliver(self, *args) -> None:
        for slot in list(self._slots):
            slot(*args[: _slot_capacity(slot, len(args))])


def _slot_capacity(slot, n_args: int) -> int:
    """How many positional args *slot* accepts (Qt truncates extras).

    Resolved from the signature UP FRONT -- catching TypeError from the
    call and retrying would re-execute a slot whose own body raised
    TypeError, duplicating its side effects.
    """
    import inspect

    try:
        params = inspect.signature(slot).parameters.values()
    except (TypeError, ValueError):
        # Signature-less C callables: assume the common one-argument slot
        # shape (setText-style).  Passing all args instead could raise
        # TypeError out of delivery, and retrying after a call would
        # double-execute slots with side effects.
        return min(n_args, 1)
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return n_args
    positional = sum(
        1 for p in params
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    )
    return min(n_args, positional)


class Signal:
    """Class-level signal descriptor (Qt's ``Signal(...)``)."""

    def __init__(self, *types):
        self._types = types
        self._name = None

    def __set_name__(self, owner, name):
        self._name = name

    def __get__(self, instance, owner=None):
        if instance is None:
            return self
        bound = _BoundSignal(instance, self._name)
        # Cache on the instance so repeat access returns the same object.
        instance.__dict__[self._name] = bound
        return bound


class QObject:
    def __init__(self, parent=None):
        self._parent = parent
        self._properties: dict[str, object] = {}
        self._object_name = ""

    def setParent(self, parent) -> None:
        self._parent = parent

    def parent(self):
        return self._parent

    def setObjectName(self, name: str) -> None:
        self._object_name = name

    def objectName(self) -> str:
        return self._object_name

    def setProperty(self, name: str, value) -> None:
        self._properties[name] = value

    def property(self, name: str):
        return self._properties.get(name)

    def blockSignals(self, block: bool) -> bool:
        """Suppress signal emission while *block* is True (Qt semantics)."""
        prev = getattr(self, "_signals_blocked", False)
        self._signals_blocked = bool(block)
        return prev


class _ColorScheme:
    Unknown, Light, Dark = 0, 1, 2


class _AlignmentFlag(int):
    pass


class Qt:
    ColorScheme = _ColorScheme
    AlignCenter = _AlignmentFlag(0x84)
    WA_TransparentForMouseEvents = 51
    Horizontal, Vertical = 1, 2


class QTimer:
    @staticmethod
    def singleShot(ms: int, fn) -> None:
        app = QApplication.instance()
        if app is None:
            fn()
            return
        app._post_delayed(ms / 1000.0, fn)


# ---------------------------------------------------------------------------
# QtGui
# ---------------------------------------------------------------------------


class QFont:
    Thin, Light, Normal, Medium, Bold = 100, 300, 400, 500, 700

    def __init__(self, family: str = "", pointSize: int = -1, weight: int = -1):
        self.family_name = family
        self.point_size = pointSize
        self.weight = weight


class QIcon:
    def __init__(self, path: str = ""):
        self.path = path


class _StyleHints:
    def colorScheme(self):
        choice = os.environ.get("CST_GUI_STUB_COLOR_SCHEME", "light").lower()
        return Qt.ColorScheme.Dark if choice == "dark" else Qt.ColorScheme.Light


class QGuiApplication:
    _hints = _StyleHints()

    @staticmethod
    def styleHints() -> _StyleHints:
        return QGuiApplication._hints


# ---------------------------------------------------------------------------
# QtWidgets
# ---------------------------------------------------------------------------


class _Style:
    def unpolish(self, w) -> None:
        pass

    def polish(self, w) -> None:
        pass


class QWidget(QObject):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._children: list[QWidget] = []
        self._layout = None
        self._visible = False
        self._window_title = ""
        self._size = (0, 0)
        self._style = _Style()
        self._style_sheet = ""
        self._fixed_height = None
        self._attributes: set = set()
        if parent is not None and hasattr(parent, "_children"):
            parent._children.append(self)

    # -- tree ---------------------------------------------------------------

    def _adopt(self, child: "QWidget") -> None:
        if child not in self._children:
            self._children.append(child)
            child._parent = self

    def findChildren(self, klass) -> list:
        out = []
        for c in self._children:
            if isinstance(c, klass):
                out.append(c)
            if isinstance(c, QWidget):
                out.extend(c.findChildren(klass))
        return out

    # -- layout / geometry ---------------------------------------------------

    def setLayout(self, layout) -> None:
        self._layout = layout
        layout._attach(self)

    def layout(self):
        return self._layout

    def setFixedHeight(self, h: int) -> None:
        self._fixed_height = h

    def setMaximumWidth(self, w: int) -> None:
        self._max_width = w

    def setWordWrap(self, on: bool) -> None:
        pass

    def setSizePolicy(self, *a) -> None:
        pass

    def setAttribute(self, attr, on: bool = True) -> None:
        if on:
            self._attributes.add(attr)
        else:
            self._attributes.discard(attr)

    def resize(self, w: int, h: int) -> None:
        self._size = (w, h)

    def setWindowTitle(self, title: str) -> None:
        self._window_title = title

    def windowTitle(self) -> str:
        return self._window_title

    def show(self) -> None:
        self._visible = True
        app = QApplication.instance()
        if app is not None and self._parent is None and self not in app._top_level:
            app._top_level.append(self)

    def isVisible(self) -> bool:
        return self._visible

    def close(self) -> None:
        self._visible = False

    def style(self) -> _Style:
        return self._style

    def setStyleSheet(self, sheet: str) -> None:
        self._style_sheet = sheet

    def styleSheet(self) -> str:
        return self._style_sheet


class _BoxLayout:
    def __init__(self, owner: QWidget | None = None):
        self._owner: QWidget | None = None
        self._items: list = []
        if owner is not None:
            owner.setLayout(self)

    def _attach(self, owner: QWidget) -> None:
        self._owner = owner
        for item in self._items:
            self._reparent(item)

    def _reparent(self, item) -> None:
        if self._owner is None:
            return
        if isinstance(item, QWidget):
            self._owner._adopt(item)
        elif isinstance(item, _BoxLayout):
            item._attach(self._owner)

    def addWidget(self, w: QWidget, *a, **k) -> None:
        self._items.append(w)
        self._reparent(w)

    def addLayout(self, layout: "_BoxLayout", *a, **k) -> None:
        self._items.append(layout)
        self._reparent(layout)

    def addStretch(self, *a) -> None:
        pass

    def setContentsMargins(self, *a) -> None:
        pass

    def setSpacing(self, *a) -> None:
        pass

    def setAlignment(self, *a) -> None:
        pass


class QVBoxLayout(_BoxLayout):
    pass


class QHBoxLayout(_BoxLayout):
    pass


class QLabel(QWidget):
    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text

    def text(self) -> str:
        return self._text

    def setText(self, text: str) -> None:
        self._text = str(text)

    def setAlignment(self, *a) -> None:
        pass

    def setPixmap(self, *a) -> None:
        pass

    def setFont(self, *a) -> None:
        pass


class QLineEdit(QWidget):
    editingFinished = Signal()

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text

    def text(self) -> str:
        return self._text

    def setText(self, text: str) -> None:
        self._text = str(text)

    def setAlignment(self, flag) -> None:
        pass

    # -- test helper: what a user typing then leaving the field does -------
    def type_text(self, text: str) -> None:
        self._text = str(text)
        self.editingFinished.emit()


class QSlider(QWidget):
    """Horizontal slider stand-in (PySide6 QSlider's used surface)."""

    valueChanged = Signal(int)

    def __init__(self, orientation=None, parent=None):
        super().__init__(parent)
        self._min, self._max, self._value = 0, 99, 0

    def setRange(self, lo: int, hi: int) -> None:
        self._min, self._max = int(lo), int(hi)
        self._value = min(max(self._value, self._min), self._max)

    def minimum(self) -> int:
        return self._min

    def maximum(self) -> int:
        return self._max

    def setValue(self, value: int) -> None:
        value = min(max(int(value), self._min), self._max)
        if value != self._value:
            self._value = value
            self.valueChanged.emit(value)

    def value(self) -> int:
        return self._value


class QPushButton(QWidget):
    clicked = Signal(bool)
    toggled = Signal(bool)

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text
        self._checkable = False
        self._checked = False

    def text(self) -> str:
        return self._text

    def setText(self, text: str) -> None:
        self._text = text

    def setCheckable(self, on: bool) -> None:
        self._checkable = on

    def isCheckable(self) -> bool:
        return self._checkable

    def setChecked(self, on: bool) -> None:
        if self._checkable and on != self._checked:
            self._checked = on
            self.toggled.emit(on)

    def isChecked(self) -> bool:
        return self._checked

    def click(self) -> None:
        if self._checkable:
            self.setChecked(not self._checked)
        self.clicked.emit(self._checked)


class QTabWidget(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._tabs: list[tuple[QWidget, str]] = []
        self._current = 0

    def addTab(self, page: QWidget, label: str) -> int:
        self._adopt(page)
        self._tabs.append((page, label))
        return len(self._tabs) - 1

    def count(self) -> int:
        return len(self._tabs)

    def tabText(self, i: int) -> str:
        return self._tabs[i][1]

    def widget(self, i: int) -> QWidget:
        return self._tabs[i][0]

    def setCurrentIndex(self, i: int) -> None:
        self._current = i

    def currentIndex(self) -> int:
        return self._current


class QStackedWidget(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._pages: list[QWidget] = []
        self._current = 0

    def addWidget(self, page: QWidget) -> int:
        self._adopt(page)
        self._pages.append(page)
        return len(self._pages) - 1

    def count(self) -> int:
        return len(self._pages)

    def widget(self, i: int) -> QWidget:
        return self._pages[i]

    def setCurrentIndex(self, i: int) -> None:
        self._current = i

    def currentIndex(self) -> int:
        return self._current


class QSizePolicy:
    Fixed, Minimum, Maximum, Preferred, Expanding = 0, 1, 4, 5, 7


class QFileDialog:
    """Headless: pickers return 'nothing chosen' (the GUI keeps the field)."""

    @staticmethod
    def getExistingDirectory(*a, **k) -> str:
        return ""

    @staticmethod
    def getOpenFileName(*a, **k) -> tuple[str, str]:
        return "", ""


class QApplication(QObject):
    _instance: "QApplication | None" = None

    #: Test seam: a callable invoked once inside ``exec()`` with the app;
    #: it drives the UI (click buttons, read labels) and should call
    #: ``app.quit()``.  Exceptions propagate out of ``exec()``.
    exec_hook = None

    #: Safety bound on ``exec()`` (seconds) so a hook that forgets to quit
    #: cannot hang a test run forever.
    exec_timeout = 120.0

    def __init__(self, argv=None):
        super().__init__()
        QApplication._instance = self
        self._gui_thread = threading.current_thread()
        self._queue: collections.deque = collections.deque()
        self._delayed: list[tuple[float, object]] = []
        self._top_level: list[QWidget] = []
        self._quit = threading.Event()
        self._style_sheet = ""

    @classmethod
    def instance(cls) -> "QApplication | None":
        return cls._instance

    def setStyleSheet(self, sheet: str) -> None:
        self._style_sheet = sheet

    def styleSheet(self) -> str:
        return self._style_sheet

    def topLevelWidgets(self) -> list[QWidget]:
        return list(self._top_level)

    def _post(self, fn) -> None:
        self._queue.append(fn)

    def _post_delayed(self, delay_s: float, fn) -> None:
        self._delayed.append((time.monotonic() + delay_s, fn))

    def processEvents(self) -> None:
        now = time.monotonic()
        due = [fn for t, fn in self._delayed if t <= now]
        self._delayed = [(t, fn) for t, fn in self._delayed if t > now]
        for fn in due:
            fn()
        while self._queue:
            self._queue.popleft()()

    def quit(self) -> None:
        self._quit.set()

    def exec(self) -> int:
        deadline = time.monotonic() + self.exec_timeout
        hook = QApplication.exec_hook
        ran_hook = False
        while not self._quit.is_set():
            self.processEvents()
            if hook is not None and not ran_hook:
                ran_hook = True
                hook(self)
                continue
            if time.monotonic() > deadline:
                raise TimeoutError("headless_qt exec() exceeded its safety bound")
            time.sleep(0.01)
        self.processEvents()  # drain anything queued during shutdown
        QApplication._instance = None
        return 0


# ---------------------------------------------------------------------------
# module registration
# ---------------------------------------------------------------------------

_QTCORE = ("QObject", "Signal", "Qt", "QTimer")
_QTGUI = ("QGuiApplication", "QFont", "QIcon")
_QTWIDGETS = (
    "QApplication",
    "QFileDialog",
    "QHBoxLayout",
    "QLabel",
    "QLineEdit",
    "QPushButton",
    "QSizePolicy",
    "QSlider",
    "QStackedWidget",
    "QTabWidget",
    "QVBoxLayout",
    "QWidget",
)


def real_pyside6_available() -> bool:
    try:
        return importlib.util.find_spec("PySide6") is not None
    except (ImportError, ValueError):
        return False


def install(force: bool = False) -> bool:
    """Register the stub as ``PySide6`` in ``sys.modules``.

    Returns True when the stub is active.  A real PySide6 install wins
    unless *force* -- the stub exists to execute the Qt front-end where Qt
    can't, not to shadow it where it can.
    """
    if not force and real_pyside6_available():
        return False
    this = sys.modules[__name__]
    pkg = types.ModuleType("PySide6")
    pkg.__path__ = []  # mark as package
    pkg.__headless_stub__ = True
    for sub, names in (("QtCore", _QTCORE), ("QtGui", _QTGUI), ("QtWidgets", _QTWIDGETS)):
        mod = types.ModuleType(f"PySide6.{sub}")
        for name in names:
            setattr(mod, name, getattr(this, name))
        setattr(pkg, sub, mod)
        sys.modules[f"PySide6.{sub}"] = mod
    sys.modules["PySide6"] = pkg
    return True


def uninstall() -> None:
    """Remove the stub from ``sys.modules`` (no-op for a real PySide6)."""
    pkg = sys.modules.get("PySide6")
    if pkg is not None and getattr(pkg, "__headless_stub__", False):
        for key in [k for k in sys.modules if k == "PySide6" or k.startswith("PySide6.")]:
            del sys.modules[key]
