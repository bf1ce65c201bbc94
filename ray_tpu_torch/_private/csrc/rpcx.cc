// rpccore: the native RPC frame pump (ROADMAP item 2 / docs/WIRE_PROTOCOL.md
// "Implementations").
//
// Owns sockets speaking the ray_tpu control-plane framing —
// [uint32_le length][msgpack body] — and moves the length-prefixed
// read / partial-write / coalesced-send loops out of Python
// (_private/protocol.py asyncio handlers). msgpack encode/decode stays in
// Python: the pump's contract is BYTES (frame boundaries), which is what
// keeps it byte-identical to the Python implementation by construction —
// both sides of every frame are produced by the same msgpack library.
//
// Design: a reactor with NO threads of its own. The caller's thread drives
// it through rpcx_next_batch (epoll_wait + reads + frame parsing run there,
// with the GIL released by ctypes), which is what lets the worker's
// direct-execution lane run recv -> decode -> execute -> reply on ONE
// thread (ray_tpu_torch/_private/direct.py). Sends may come from ANY thread:
// they write straight to the fd under a per-connection mutex (partial
// writes looped with poll), so a reply never waits on the reactor.
//
// Role-equivalent to the reference's gRPC C-core event engine
// (reference: src/ray/rpc/ client_call.h / grpc_server.cc) at the scale
// this runtime needs: one pump per process role, O(10) connections.
//
// Built like store.cc and schedcore.cc, by ray_tpu_torch/_private/native.py:
//   g++ -O2 -fPIC -shared -o ray_tpu_torch/core/librpcx.so \
//       ray_tpu_torch/_private/csrc/rpcx.cc
// (ray_tpu_torch/_private/rpccore.py builds it on demand and falls back to the
// pure-Python path when the build or load fails.)

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/un.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMaxFrame = 256u * 1024u * 1024u;  // protocol._MAX_FRAME
constexpr int kReadChunk = 256 * 1024;

// event kinds delivered to Python
constexpr int kKindFrame = 1;
constexpr int kKindClosed = 2;
constexpr int kKindWake = 3;  // rpcx_wake: a thread wants the reactor

struct Conn {
  int fd = -1;
  long id = 0;
  bool closed = false;           // fd shut; send() refuses
  std::vector<uint8_t> rbuf;     // unparsed inbound bytes
  size_t rhead = 0;              // parse cursor into rbuf
  std::mutex wmu;                // serializes writers (coalesces under
                                 // contention: later senders append while
                                 // an earlier writev is in flight)
};

struct Event {
  long cid = 0;
  int kind = 0;
  uint8_t* data = nullptr;  // malloc'd frame body (caller frees)
  uint32_t len = 0;
};

struct Pump {
  int ep = -1;
  int wake_fd = -1;
  int listen_fd = -1;      // AF_UNIX listener (tag UINT64_MAX - 1)
  int listen_fd_tcp = -1;  // AF_INET listener (tag UINT64_MAX - 2)
  std::mutex mu;  // conns map + event queue + ids
  std::unordered_map<long, Conn*> conns;
  std::deque<Event> q;
  long next_id = 1;
  std::atomic<bool> shutdown{false};
  std::mutex reactor_mu;  // at most one thread inside epoll_wait
  // stats (indexes documented at rpcx_stats)
  std::atomic<uint64_t> frames_in{0}, frames_out{0};
  std::atomic<uint64_t> bytes_in{0}, bytes_out{0};
  std::atomic<uint64_t> read_calls{0}, write_calls{0};
};

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

int64_t now_ms() {
  struct timeval tv;
  gettimeofday(&tv, nullptr);
  return int64_t(tv.tv_sec) * 1000 + tv.tv_usec / 1000;
}

// TCP fast-path socket options; silently no-ops on AF_UNIX fds (the
// setsockopt fails with EOPNOTSUPP and we don't care)
void set_tcp_opts(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  setsockopt(fd, SOL_SOCKET, SO_KEEPALIVE, &one, sizeof(one));
}

Conn* add_conn(Pump* p, int fd) {
  set_nonblock(fd);
  set_tcp_opts(fd);
  auto* c = new Conn();
  c->fd = fd;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    c->id = p->next_id++;
    p->conns[c->id] = c;
  }
  struct epoll_event ev;
  std::memset(&ev, 0, sizeof(ev));
  ev.events = EPOLLIN;
  ev.data.u64 = static_cast<uint64_t>(c->id);
  epoll_ctl(p->ep, EPOLL_CTL_ADD, fd, &ev);
  return c;
}

// mark closed + queue the close event; Conn structs live until pump
// shutdown (a send racing the close must find a poisoned conn, not freed
// memory — connection churn here is lease-lifetime, not per-request)
void close_conn_locked(Pump* p, Conn* c) {
  if (c->closed) return;
  c->closed = true;
  epoll_ctl(p->ep, EPOLL_CTL_DEL, c->fd, nullptr);
  ::close(c->fd);
  Event e;
  e.cid = c->id;
  e.kind = kKindClosed;
  p->q.push_back(e);
}

// parse complete frames out of c->rbuf into the event queue
void parse_frames(Pump* p, Conn* c) {
  for (;;) {
    size_t avail = c->rbuf.size() - c->rhead;
    if (avail < 4) break;
    const uint8_t* base = c->rbuf.data() + c->rhead;
    uint32_t n;
    std::memcpy(&n, base, 4);  // uint32 little-endian on every TPU host
    if (n > kMaxFrame) {  // protocol error, same as read_frame()
      std::lock_guard<std::mutex> lk(p->mu);
      close_conn_locked(p, c);
      return;
    }
    if (avail < 4u + n) break;
    auto* body = static_cast<uint8_t*>(std::malloc(n ? n : 1));
    std::memcpy(body, base + 4, n);
    c->rhead += 4u + n;
    Event e;
    e.cid = c->id;
    e.kind = kKindFrame;
    e.data = body;
    e.len = n;
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->q.push_back(e);
    }
    p->frames_in.fetch_add(1, std::memory_order_relaxed);
  }
  // compact once the parsed prefix dominates (keeps the buffer O(frame))
  if (c->rhead > 0 && c->rhead * 2 >= c->rbuf.size()) {
    c->rbuf.erase(c->rbuf.begin(), c->rbuf.begin() + c->rhead);
    c->rhead = 0;
  }
}

void drain_readable(Pump* p, Conn* c) {
  for (;;) {
    size_t old = c->rbuf.size();
    c->rbuf.resize(old + kReadChunk);
    ssize_t n = ::recv(c->fd, c->rbuf.data() + old, kReadChunk, 0);
    p->read_calls.fetch_add(1, std::memory_order_relaxed);
    if (n > 0) {
      c->rbuf.resize(old + n);
      p->bytes_in.fetch_add(n, std::memory_order_relaxed);
      parse_frames(p, c);
      if (c->closed) return;
      if (n < kReadChunk) return;  // drained
      continue;
    }
    c->rbuf.resize(old);
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return;
    // EOF or hard error
    std::lock_guard<std::mutex> lk(p->mu);
    close_conn_locked(p, c);
    return;
  }
}

void accept_ready(Pump* p, int listen_fd) {
  for (;;) {
    int fd = ::accept4(listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
    if (fd < 0) return;
    add_conn(p, fd);
  }
}

// run the reactor once (events + reads); returns when something was
// enqueued or the timeout elapsed
void reactor_step(Pump* p, int timeout_ms) {
  struct epoll_event evs[64];
  int n = epoll_wait(p->ep, evs, 64, timeout_ms);
  for (int i = 0; i < n; i++) {
    uint64_t tag = evs[i].data.u64;
    if (tag == UINT64_MAX) {  // wake eventfd
      uint64_t buf;
      while (::read(p->wake_fd, &buf, 8) == 8) {
      }
      continue;
    }
    if (tag == UINT64_MAX - 1) {  // unix listener
      accept_ready(p, p->listen_fd);
      continue;
    }
    if (tag == UINT64_MAX - 2) {  // tcp listener
      accept_ready(p, p->listen_fd_tcp);
      continue;
    }
    Conn* c = nullptr;
    {
      std::lock_guard<std::mutex> lk(p->mu);
      auto it = p->conns.find(static_cast<long>(tag));
      if (it != p->conns.end() && !it->second->closed) c = it->second;
    }
    if (c == nullptr) continue;
    if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
      // drain what the kernel still buffers, then close
      drain_readable(p, c);
      std::lock_guard<std::mutex> lk(p->mu);
      close_conn_locked(p, c);
      continue;
    }
    if (evs[i].events & EPOLLIN) drain_readable(p, c);
  }
}

}  // namespace

extern "C" {

// bumped on any signature/semantic change; the Python loader refuses a
// stale .so (a rebuilt checkout can otherwise load yesterday's binary)
int rpcx_abi_version() { return 4; }

void* rpcx_create() {
  auto* p = new Pump();
  p->ep = epoll_create1(EPOLL_CLOEXEC);
  p->wake_fd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  struct epoll_event ev;
  std::memset(&ev, 0, sizeof(ev));
  ev.events = EPOLLIN;
  ev.data.u64 = UINT64_MAX;
  epoll_ctl(p->ep, EPOLL_CTL_ADD, p->wake_fd, &ev);
  return p;
}

int rpcx_listen(void* vp, const char* path) {
  auto* p = static_cast<Pump*>(vp);
  int fd = ::socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (fd < 0) return -1;
  struct sockaddr_un addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  std::strncpy(addr.sun_path, path, sizeof(addr.sun_path) - 1);
  ::unlink(path);
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 128) < 0) {
    ::close(fd);
    return -1;
  }
  set_nonblock(fd);
  p->listen_fd = fd;
  struct epoll_event ev;
  std::memset(&ev, 0, sizeof(ev));
  ev.events = EPOLLIN;
  ev.data.u64 = UINT64_MAX - 1;
  epoll_ctl(p->ep, EPOLL_CTL_ADD, fd, &ev);
  return 0;
}

// TCP listener (netx off-box transport). Binds host:port (port 0 =
// ephemeral) and returns the BOUND port, or -1. Framing on accepted
// connections is byte-identical to the unix path — same parse_frames,
// same kMaxFrame — so the schema-1.7 conformance vectors run unchanged.
int rpcx_listen_tcp(void* vp, const char* host, int port) {
  auto* p = static_cast<Pump*>(vp);
  int fd = ::socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;
  }
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 128) < 0) {
    ::close(fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  if (::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen) < 0) {
    ::close(fd);
    return -1;
  }
  set_nonblock(fd);
  p->listen_fd_tcp = fd;
  struct epoll_event ev;
  std::memset(&ev, 0, sizeof(ev));
  ev.events = EPOLLIN;
  ev.data.u64 = UINT64_MAX - 2;
  epoll_ctl(p->ep, EPOLL_CTL_ADD, fd, &ev);
  return ntohs(addr.sin_port);
}

// Dial host:port. Hostname resolution via getaddrinfo (numeric IPs skip
// the resolver). Blocking connect, same as the unix dial — callers hold
// no pump lock while dialing.
long rpcx_dial_tcp(void* vp, const char* host, int port) {
  auto* p = static_cast<Pump*>(vp);
  struct addrinfo hints;
  std::memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portbuf[16];
  std::snprintf(portbuf, sizeof(portbuf), "%d", port);
  struct addrinfo* res = nullptr;
  if (::getaddrinfo(host, portbuf, &hints, &res) != 0 || res == nullptr)
    return -1;
  int fd = ::socket(res->ai_family, res->ai_socktype | SOCK_CLOEXEC,
                    res->ai_protocol);
  if (fd < 0) {
    ::freeaddrinfo(res);
    return -1;
  }
  int rc = ::connect(fd, res->ai_addr, res->ai_addrlen);
  ::freeaddrinfo(res);
  if (rc < 0) {
    ::close(fd);
    return -1;
  }
  Conn* c = add_conn(p, fd);
  uint64_t one = 1;
  ssize_t wrc = ::write(p->wake_fd, &one, 8);
  (void)wrc;
  return c->id;
}

long rpcx_dial(void* vp, const char* path) {
  auto* p = static_cast<Pump*>(vp);
  int fd = ::socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (fd < 0) return -1;
  struct sockaddr_un addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  std::strncpy(addr.sun_path, path, sizeof(addr.sun_path) - 1);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return -1;
  }
  Conn* c = add_conn(p, fd);
  // wake a parked reactor so the new fd joins its epoll set promptly
  uint64_t one = 1;
  ssize_t rc = ::write(p->wake_fd, &one, 8);
  (void)rc;
  return c->id;
}

// Pop up to `max` events. kinds[i]: 1=frame (datas/lens set), 2=conn
// closed. Returns the count, 0 on timeout, -1 after shutdown. Batching
// amortizes the C<->Python boundary when a socket read yielded several
// frames (pipelined leased tasks, coalesced peers).
int rpcx_next_batch(void* vp, long* cids, int* kinds, uint8_t** datas,
                    uint32_t* lens, int max, int timeout_ms) {
  auto* p = static_cast<Pump*>(vp);
  int64_t deadline = timeout_ms >= 0 ? now_ms() + timeout_ms : -1;
  for (;;) {
    {
      std::lock_guard<std::mutex> lk(p->mu);
      if (!p->q.empty()) {
        int n = 0;
        while (n < max && !p->q.empty()) {
          Event e = p->q.front();
          p->q.pop_front();
          cids[n] = e.cid;
          kinds[n] = e.kind;
          datas[n] = e.data;
          lens[n] = e.len;
          n++;
        }
        return n;
      }
    }
    if (p->shutdown.load()) return -1;
    int step;
    if (deadline < 0) {
      step = 200;  // re-check shutdown periodically even without timeout
    } else {
      int64_t left = deadline - now_ms();
      if (left <= 0) return 0;
      step = left > 200 ? 200 : static_cast<int>(left);
    }
    std::lock_guard<std::mutex> rk(p->reactor_mu);
    reactor_step(p, step);
  }
}

void rpcx_free(uint8_t* data) { std::free(data); }

// Send one frame: writes [uint32_le len][body]. Returns 0, or -1 when the
// connection is unknown/closed or the write fails. Partial writes loop
// with poll (the "partial-write loop" that used to live in asyncio's
// transport); concurrent senders serialize on the conn mutex, so bodies
// from racing threads interleave at frame granularity only.
int rpcx_send(void* vp, long cid, const uint8_t* body, uint32_t len) {
  auto* p = static_cast<Pump*>(vp);
  if (len > kMaxFrame) return -1;
  Conn* c = nullptr;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    auto it = p->conns.find(cid);
    if (it == p->conns.end()) return -1;
    c = it->second;
  }
  std::lock_guard<std::mutex> wk(c->wmu);
  if (c->closed) return -1;
  uint8_t hdr[4];
  std::memcpy(hdr, &len, 4);
  struct iovec iov[2];
  iov[0].iov_base = hdr;
  iov[0].iov_len = 4;
  iov[1].iov_base = const_cast<uint8_t*>(body);
  iov[1].iov_len = len;
  size_t total = 4u + len, sent = 0;
  while (sent < total) {
    struct msghdr mh;
    std::memset(&mh, 0, sizeof(mh));
    // advance the iovec past what's already on the wire
    struct iovec cur[2];
    int niov = 0;
    size_t skip = sent;
    for (int i = 0; i < 2; i++) {
      if (skip >= iov[i].iov_len) {
        skip -= iov[i].iov_len;
        continue;
      }
      cur[niov].iov_base = static_cast<uint8_t*>(iov[i].iov_base) + skip;
      cur[niov].iov_len = iov[i].iov_len - skip;
      skip = 0;
      niov++;
    }
    mh.msg_iov = cur;
    mh.msg_iovlen = niov;
    ssize_t n = ::sendmsg(c->fd, &mh, MSG_NOSIGNAL);
    p->write_calls.fetch_add(1, std::memory_order_relaxed);
    if (n > 0) {
      sent += static_cast<size_t>(n);
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      struct pollfd pf;
      pf.fd = c->fd;
      pf.events = POLLOUT;
      if (::poll(&pf, 1, 30000) <= 0) return -1;  // wedged peer
      continue;
    }
    if (n < 0 && errno == EINTR) continue;
    return -1;
  }
  p->frames_out.fetch_add(1, std::memory_order_relaxed);
  p->bytes_out.fetch_add(total, std::memory_order_relaxed);
  return 0;
}

int rpcx_close_conn(void* vp, long cid) {
  auto* p = static_cast<Pump*>(vp);
  std::lock_guard<std::mutex> lk(p->mu);
  auto it = p->conns.find(cid);
  if (it == p->conns.end()) return -1;
  close_conn_locked(p, it->second);
  return 0;
}

// Post a synthetic wake event: bounces whichever thread is inside
// rpcx_next_batch out of its epoll promptly (the Python side uses this
// to hand the reactor from the background delivery thread to a getter
// thread that wants to reap its own reply inline).
void rpcx_wake(void* vp) {
  auto* p = static_cast<Pump*>(vp);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    Event e;
    e.cid = 0;
    e.kind = kKindWake;
    p->q.push_back(e);
  }
  uint64_t one = 1;
  ssize_t rc = ::write(p->wake_fd, &one, 8);
  (void)rc;
}

void rpcx_shutdown(void* vp) {
  auto* p = static_cast<Pump*>(vp);
  p->shutdown.store(true);
  uint64_t one = 1;
  ssize_t rc = ::write(p->wake_fd, &one, 8);
  (void)rc;
}

// full teardown; only call after the lane thread left rpcx_next_batch
void rpcx_destroy(void* vp) {
  auto* p = static_cast<Pump*>(vp);
  p->shutdown.store(true);
  std::lock_guard<std::mutex> rk(p->reactor_mu);
  std::lock_guard<std::mutex> lk(p->mu);
  for (auto& kv : p->conns) {
    if (!kv.second->closed) ::close(kv.second->fd);
    delete kv.second;
  }
  p->conns.clear();
  for (auto& e : p->q) std::free(e.data);
  p->q.clear();
  if (p->listen_fd >= 0) ::close(p->listen_fd);
  if (p->listen_fd_tcp >= 0) ::close(p->listen_fd_tcp);
  ::close(p->wake_fd);
  ::close(p->ep);
  delete p;
}

// out[6]: frames_in, frames_out, bytes_in, bytes_out, read_calls,
// write_calls — read_calls < frames_in is the coalescing proof
void rpcx_stats(void* vp, uint64_t* out) {
  auto* p = static_cast<Pump*>(vp);
  out[0] = p->frames_in.load();
  out[1] = p->frames_out.load();
  out[2] = p->bytes_in.load();
  out[3] = p->bytes_out.load();
  out[4] = p->read_calls.load();
  out[5] = p->write_calls.load();
}

}  // extern "C"
