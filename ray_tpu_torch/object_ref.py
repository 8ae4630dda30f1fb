# Copied from ray_tpu/object_ref.py (JAX-free): module names read ray_tpu_torch.
"""ObjectRef — a future naming an immutable object in the cluster.

Mirrors the reference's ObjectRef (reference: python/ray/_raylet.pyx:269
ObjectRef class): holds the binary object id, supports `get`-via-API,
equality/hashing by id, and releases its reference on garbage
collection so the owner can free the object (reference:
core_worker/reference_count.h owner-based refcounting).
"""

from __future__ import annotations

from ._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_owner", "__weakref__")

    def __init__(self, object_id: ObjectID, owner=None, skip_adding_ref=False):
        self._id = object_id
        self._owner = owner
        if owner is not None and not skip_adding_ref:
            owner.add_local_ref(object_id)

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __del__(self):
        owner = self._owner
        if owner is not None:
            try:
                owner.remove_local_ref(self._id)
            except Exception:
                pass

    def __reduce__(self):
        # Refs serialized into task args / object values re-attach to
        # the receiving process's worker on deserialization. A ref
        # escaping its owner must first be globally visible: direct
        # transport results live only in the owner's futures until
        # published to the daemon's object table.
        owner = self._owner
        if owner is not None:
            visible = getattr(owner, "ensure_globally_visible", None)
            if visible is not None:
                visible(self._id)
        return (_deserialize_ref, (self._id.binary(),))

    # `await ref` support for async drivers.
    def __await__(self):
        from . import api

        result = yield from _async_get(self).__await__()
        return result

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        import concurrent.futures
        import threading

        from . import api

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(api.get(self))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut


async def _async_get(ref: ObjectRef):
    import asyncio

    return await asyncio.wrap_future(ref.future())


class ObjectRefGenerator:
    """Iterator over the ObjectRefs a generator task produces.

    Mirrors the reference's streaming/dynamic generator protocol
    (reference: python/ray/_raylet.pyx:269 ObjectRefGenerator;
    remote_function.py:385-391 num_returns="dynamic"/"streaming"):

    - Item object ids are **deterministic** — item *i* is
      ``ObjectID.for_return(task_id, i + 2)`` (index 1 is the task's
      primary return, which doubles as the completion marker carrying
      the final item count, stored by the worker AFTER every item is
      sealed). No extra control traffic is needed to stream.
    - Streaming mode: ``__next__`` blocks until item *i* is sealed or
      the completion marker lands (count known -> StopIteration, task
      error -> raised here).
    - Dynamic mode: the completion marker's VALUE is this generator
      (count pre-resolved), so ``get(ref)`` on a dynamic task returns
      an ObjectRefGenerator, per the reference's API.
    """

    def __init__(self, task_id, owner=None, count=None, primary_ref=None):
        self._task_id = task_id
        self._owner = owner
        self._count = count
        self._index = 0
        #: Held for the generator's lifetime while streaming: dropping
        #: the last local ref to the completion marker would release
        #: its owner-side future (and eventually the daemon entry)
        #: while __next__ still needs it.
        self._primary_ref: ObjectRef | None = primary_ref

    def _ref(self, object_id: ObjectID) -> ObjectRef:
        return ObjectRef(object_id, owner=self._owner)

    def _item_id(self, i: int) -> ObjectID:
        return ObjectID.for_return(self._task_id, i + 2)

    @property
    def completed_ref(self) -> ObjectRef:
        """Ref of the completion marker (resolves to the item count
        once the whole generator has run; errors if the task failed)."""
        if self._primary_ref is None:
            self._primary_ref = self._ref(
                ObjectID.for_return(self._task_id, 1)
            )
        return self._primary_ref

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        if self._owner is None:
            from ._private.worker import global_worker

            self._owner = global_worker()
        if self._count is not None:
            if self._index >= self._count:
                raise StopIteration
            ref = self._ref(self._item_id(self._index))
            self._index += 1
            return ref
        item = self._ref(self._item_id(self._index))
        primary = self.completed_ref
        while True:
            ready, _ = self._owner.wait(
                [item, primary], num_returns=1, timeout=30.0
            )
            if item in ready:
                self._index += 1
                return item
            if primary in ready:
                error = self._owner.peek_object_error(primary.id())
                if error is not None:
                    # Mid-stream failure: drain the items the worker
                    # sealed before erroring (their count rides in the
                    # payload), then re-raise the task's error.
                    import pickle as _pickle

                    emitted = _pickle.loads(error).get(
                        "items_emitted", 0
                    )
                    if self._index < (emitted or 0):
                        self._index += 1
                        return item
                    self._owner.get([primary])  # raises the error
                # Worker seals the marker after the last item, so by
                # now either index < count (item is sealed) or we are
                # past the end.
                marker = self._owner.get([primary])[0]
                self._count = (
                    marker._count
                    if isinstance(marker, ObjectRefGenerator)
                    else int(marker)
                )
                if self._index >= self._count:
                    raise StopIteration
                self._index += 1
                return item

    next = __next__

    def __reduce__(self):
        return (
            _deserialize_generator,
            (self._task_id.binary(), self._count),
        )

    def __repr__(self):
        return (
            f"ObjectRefGenerator(task={self._task_id.hex()}, "
            f"count={self._count}, index={self._index})"
        )


def _deserialize_generator(task_binary: bytes, count):
    from ._private.ids import TaskID
    from ._private.worker import global_worker

    return ObjectRefGenerator(
        TaskID(task_binary), owner=global_worker(), count=count
    )


def _deserialize_ref(binary: bytes) -> ObjectRef:
    from ._private.worker import global_worker

    oid = ObjectID(binary)
    worker = global_worker()
    if worker is not None:
        worker.notify_borrowed_ref(oid)
        return ObjectRef(oid, owner=worker)
    return ObjectRef(oid)
