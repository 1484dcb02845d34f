"""Exception hierarchy (copy of ``ksql_tpu/common/errors.py``, the classes
the port raises)."""


class KsqlException(Exception):
    """Base class for all framework errors."""


class SerdeException(KsqlException):
    pass


class QueryRuntimeException(KsqlException):
    pass
