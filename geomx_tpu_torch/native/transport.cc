// geomx_tpu native transport core.
//
// The C++ counterpart of the Python van's socket layer — the role ZMQVan
// plays for ps-lite in the reference (3rdparty/ps-lite/src/zmq_van.h:41-516:
// Bind/Connect/SendMsg/RecvMsg over persistent per-peer connections), built
// on raw POSIX TCP sockets instead of ZeroMQ.
//
// Scope: frame transport only. It owns
//   - the listener socket + accept thread,
//   - one reader thread per inbound connection, each parsing frame
//     boundaries (17-byte preheader | meta | u32 ndata | {u32 len|part}*)
//     and enqueueing complete frames,
//   - a bounded inbound frame queue drained by the host (Python) through
//     gx_recv,
//   - outbound connections dialed lazily per destination id and cached
//     (reference: zmq_van.h:160-196 Connect caches per-id sockets),
//   - eviction + single redial on send failure (peer restart recovery).
//
// Routing, rendezvous, barriers, and message semantics stay in the host —
// this layer never inspects the JSON meta, only the fixed preheader.
//
// Wire format (must match geomx_tpu/ps/message.py):
//   u32 magic "GEOM" | i32 recver | u8 flags | i32 priority | u32 meta_len
//   | meta bytes | u32 ndata | { u32 len | bytes } * ndata
// all little-endian, no padding (preheader is 17 bytes).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x47454F4D;  // "GEOM"
constexpr size_t kPrehdrSize = 4 + 4 + 1 + 4 + 4;
constexpr size_t kMaxFrame = size_t(1) << 31;  // 2 GiB sanity bound
constexpr size_t kMaxParts = 1 << 20;

int SetNoDelay(int fd) {
  int one = 1;
  return setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

bool SendAll(int fd, const uint8_t* buf, size_t len) {
  size_t off = 0;
  while (off < len) {
    ssize_t n = ::send(fd, buf + off, len - off, MSG_NOSIGNAL);
    if (n <= 0) {
      if (n < 0 && (errno == EINTR)) continue;
      return false;
    }
    off += size_t(n);
  }
  return true;
}

bool RecvExact(int fd, uint8_t* buf, size_t len) {
  size_t off = 0;
  while (off < len) {
    ssize_t n = ::recv(fd, buf + off, len - off, 0);
    if (n <= 0) {
      if (n < 0 && errno == EINTR) continue;
      return false;
    }
    off += size_t(n);
  }
  return true;
}

// Resolve host (IPv4 literal or DNS name) into addr. The Python backend
// resolves via getaddrinfo inside socket.connect; the native path must
// accept the same host strings.
bool ResolveIpv4(const char* host, int port, sockaddr_in* addr) {
  std::memset(addr, 0, sizeof(*addr));
  addr->sin_family = AF_INET;
  addr->sin_port = htons(uint16_t(port));
  if (inet_pton(AF_INET, host, &addr->sin_addr) == 1) return true;
  struct addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  if (getaddrinfo(host, nullptr, &hints, &res) != 0 || res == nullptr)
    return false;
  addr->sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
  freeaddrinfo(res);
  return true;
}

int DialTcp(const char* host, int port, double timeout_s) {
  sockaddr_in addr{};
  if (!ResolveIpv4(host, port, &addr)) return -1;
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  if (timeout_s > 0) {
    struct timeval tv;
    tv.tv_sec = long(timeout_s);
    tv.tv_usec = long((timeout_s - double(tv.tv_sec)) * 1e6);
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  SetNoDelay(fd);
  return fd;
}

// Read one complete frame from fd into out. Returns false on EOF/error.
bool ReadFrame(int fd, std::string* out) {
  uint8_t hdr[kPrehdrSize];
  if (!RecvExact(fd, hdr, kPrehdrSize)) return false;
  uint32_t magic, meta_len;
  std::memcpy(&magic, hdr, 4);
  std::memcpy(&meta_len, hdr + 13, 4);
  if (magic != kMagic) return false;
  if (meta_len > kMaxFrame) return false;
  out->clear();
  out->reserve(kPrehdrSize + meta_len + 4);
  out->append(reinterpret_cast<char*>(hdr), kPrehdrSize);
  size_t off = out->size();
  out->resize(off + meta_len + 4);
  if (!RecvExact(fd, reinterpret_cast<uint8_t*>(&(*out)[off]), meta_len + 4))
    return false;
  uint32_t ndata;
  std::memcpy(&ndata, &(*out)[off + meta_len], 4);
  if (ndata > kMaxParts) return false;
  for (uint32_t i = 0; i < ndata; ++i) {
    uint8_t lenb[4];
    if (!RecvExact(fd, lenb, 4)) return false;
    uint32_t n;
    std::memcpy(&n, lenb, 4);
    if (n > kMaxFrame || out->size() + n + 4 > kMaxFrame) return false;
    size_t poff = out->size();
    out->resize(poff + 4 + n);
    std::memcpy(&(*out)[poff], lenb, 4);
    if (n && !RecvExact(fd, reinterpret_cast<uint8_t*>(&(*out)[poff + 4]), n))
      return false;
  }
  return true;
}

struct Route {
  std::string host;
  int port = 0;
  int fd = -1;
  std::mutex send_mu;
};

class Transport {
 public:
  Transport(const char* bind_host, int port)
      : bind_host_(bind_host ? bind_host : "127.0.0.1") {
    listener_ = ::socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(listener_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    if (!ResolveIpv4(bind_host_.c_str(), port, &addr) ||
        ::bind(listener_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
        ::listen(listener_, 128) != 0) {
      ::close(listener_);
      listener_ = -1;
      return;
    }
    sockaddr_in got{};
    socklen_t gl = sizeof(got);
    getsockname(listener_, reinterpret_cast<sockaddr*>(&got), &gl);
    port_ = ntohs(got.sin_port);
    accept_thread_ = std::thread([this] { AcceptLoop(); });
  }

  ~Transport() { Stop(); }

  bool ok() const { return listener_ >= 0; }
  int port() const { return port_; }

  // fd discipline (one process hosts many transports, so a stale close()
  // on a reused fd NUMBER can kill an unrelated van's socket):
  //  - a route's fd is closed only under its send_mu (Send also closes
  //    there on failure);
  //  - a reader's fd is closed exactly once, by its own reader thread,
  //    under readers_mu_; Stop only shutdown()s fds still listed there;
  //  - reader threads are joined outside readers_mu_ (they need it to
  //    deregister their fd on exit).
  void Stop() {
    bool was = stopped_.exchange(true);
    if (was) return;
    {
      std::lock_guard<std::mutex> lk(queue_mu_);
      queue_cv_.notify_all();
    }
    if (listener_ >= 0) ::shutdown(listener_, SHUT_RDWR);
    if (accept_thread_.joinable()) accept_thread_.join();
    // close only after the join: closing first frees the fd number for
    // reuse while the accept thread may still be entering ::accept on it
    if (listener_ >= 0) ::close(listener_);
    // no new readers can appear past this point
    {
      std::lock_guard<std::mutex> lk(readers_mu_);
      for (int fd : reader_fds_) ::shutdown(fd, SHUT_RDWR);
    }
    std::vector<std::thread> readers;
    {
      std::lock_guard<std::mutex> lk(readers_mu_);
      readers.swap(reader_threads_);
    }
    for (auto& t : readers)
      if (t.joinable()) t.join();
    std::vector<std::shared_ptr<Route>> routes;
    {
      std::lock_guard<std::mutex> lk(routes_mu_);
      for (auto& kv : routes_) routes.push_back(kv.second);
      routes_.clear();
    }
    for (auto& r : routes) {
      std::lock_guard<std::mutex> lk(r->send_mu);
      if (r->fd >= 0) {
        ::close(r->fd);
        r->fd = -1;
      }
    }
  }

  // Register/refresh the route for a node id; evicts a cached connection
  // if the address changed (peer recovered elsewhere — reference:
  // van.cc:176-193 + the Python van's _evict_conn on table update).
  void SetRoute(int id, const char* host, int port) {
    std::shared_ptr<Route> stale;
    {
      std::lock_guard<std::mutex> lk(routes_mu_);
      auto it = routes_.find(id);
      if (it != routes_.end()) {
        if (it->second->host == host && it->second->port == port) return;
        stale = it->second;
        routes_.erase(it);
      }
      auto r = std::make_shared<Route>();
      r->host = host;
      r->port = port;
      routes_[id] = std::move(r);
    }
    if (stale) {
      std::lock_guard<std::mutex> lk(stale->send_mu);
      if (stale->fd >= 0) {
        ::close(stale->fd);
        stale->fd = -1;
      }
    }
  }

  // Framed send with connection reuse and one redial on failure.
  int64_t Send(int id, const uint8_t* buf, size_t len) {
    std::shared_ptr<Route> r;
    {
      std::lock_guard<std::mutex> lk(routes_mu_);
      auto it = routes_.find(id);
      if (it == routes_.end()) return -2;  // no route
      r = it->second;
    }
    std::lock_guard<std::mutex> lk(r->send_mu);
    for (int attempt = 0; attempt < 2; ++attempt) {
      if (r->fd >= 0) {
        // probe for a half-closed peer: connections are unidirectional
        // (dialer writes, acceptor reads), so any readable byte/EOF on
        // our outbound socket means the peer went away — redial instead
        // of losing the frame in a dead send buffer
        char probe;
        ssize_t p = ::recv(r->fd, &probe, 1, MSG_PEEK | MSG_DONTWAIT);
        if (p == 0 || (p < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
          ::close(r->fd);
          r->fd = -1;
        }
      }
      if (r->fd < 0) {
        r->fd = DialTcp(r->host.c_str(), r->port, 10.0);
        if (r->fd < 0) {
          if (debug()) {
            fprintf(stderr, "gx_send: dial %s:%d for node %d failed: %s\n",
                    r->host.c_str(), r->port, id, strerror(errno));
          }
          continue;
        }
      }
      if (SendAll(r->fd, buf, len)) {
        send_bytes_ += len;
        return int64_t(len);
      }
      if (debug()) {
        fprintf(stderr, "gx_send: write to node %d (%s:%d) failed: %s\n", id,
                r->host.c_str(), r->port, strerror(errno));
      }
      ::close(r->fd);
      r->fd = -1;
    }
    return -1;
  }

  static bool debug() {
    static const bool on = [] {
      const char* v = getenv("GEOMX_NATIVE_DEBUG");
      return v && v[0] == '1';
    }();
    return on;
  }

  // One-shot connect+send+close (pre-rendezvous registration).
  int64_t SendToAddr(const char* host, int port, const uint8_t* buf,
                     size_t len) {
    int fd = DialTcp(host, port, 10.0);
    if (fd < 0) return -1;
    bool ok = SendAll(fd, buf, len);
    ::close(fd);
    if (!ok) return -1;
    send_bytes_ += len;
    return int64_t(len);
  }

  // Pop one complete inbound frame. Returns:
  //   >=0 frame length (frame copied into *out, caller frees with gx_free)
  //   -1 timeout, -2 stopped.
  int64_t Recv(uint8_t** out, double timeout_s) {
    std::unique_lock<std::mutex> lk(queue_mu_);
    auto pred = [this] { return !queue_.empty() || stopped_.load(); };
    if (timeout_s < 0) {
      queue_cv_.wait(lk, pred);
    } else {
      if (!queue_cv_.wait_for(
              lk, std::chrono::duration<double>(timeout_s), pred))
        return -1;
    }
    if (queue_.empty()) return stopped_.load() ? -2 : -1;
    // allocate before dequeuing so an allocation failure doesn't lose
    // the frame — the caller can retry
    uint8_t* buf = static_cast<uint8_t*>(::malloc(queue_.front().size()));
    if (!buf) return -3;
    std::string frame = std::move(queue_.front());
    queue_.pop_front();
    lk.unlock();
    std::memcpy(buf, frame.data(), frame.size());
    *out = buf;
    return int64_t(frame.size());
  }

  uint64_t send_bytes() const { return send_bytes_.load(); }
  uint64_t recv_bytes() const { return recv_bytes_.load(); }

 private:
  void AcceptLoop() {
    while (!stopped_.load()) {
      sockaddr_in peer{};
      socklen_t pl = sizeof(peer);
      int fd = ::accept(listener_, reinterpret_cast<sockaddr*>(&peer), &pl);
      if (fd < 0) {
        if (stopped_.load()) return;
        if (errno == EINTR) continue;
        return;
      }
      SetNoDelay(fd);
      std::lock_guard<std::mutex> lk(readers_mu_);
      reader_fds_.push_back(fd);
      reader_threads_.emplace_back([this, fd] { ReaderLoop(fd); });
    }
  }

  void ReaderLoop(int fd) {
    std::string frame;
    while (!stopped_.load()) {
      if (!ReadFrame(fd, &frame)) break;
      recv_bytes_ += frame.size();
      std::lock_guard<std::mutex> lk(queue_mu_);
      queue_.push_back(std::move(frame));
      frame.clear();
      queue_cv_.notify_one();
    }
    // close + deregister atomically so Stop never shutdown()s a reused
    // fd number
    std::lock_guard<std::mutex> lk(readers_mu_);
    ::close(fd);
    reader_fds_.erase(
        std::find(reader_fds_.begin(), reader_fds_.end(), fd));
  }

  std::string bind_host_;
  int listener_ = -1;
  int port_ = 0;
  std::atomic<bool> stopped_{false};

  std::thread accept_thread_;
  std::mutex readers_mu_;
  std::vector<std::thread> reader_threads_;
  std::vector<int> reader_fds_;

  std::mutex routes_mu_;
  std::map<int, std::shared_ptr<Route>> routes_;

  std::mutex queue_mu_;
  std::condition_variable queue_cv_;
  std::deque<std::string> queue_;

  std::atomic<uint64_t> send_bytes_{0};
  std::atomic<uint64_t> recv_bytes_{0};
};

}  // namespace

extern "C" {

void* gx_create(const char* bind_host, int port) {
  auto* t = new Transport(bind_host, port);
  if (!t->ok()) {
    delete t;
    return nullptr;
  }
  return t;
}

int gx_port(void* h) { return static_cast<Transport*>(h)->port(); }

void gx_set_route(void* h, int id, const char* host, int port) {
  static_cast<Transport*>(h)->SetRoute(id, host, port);
}

int64_t gx_send(void* h, int id, const uint8_t* buf, uint64_t len) {
  return static_cast<Transport*>(h)->Send(id, buf, size_t(len));
}

int64_t gx_send_addr(void* h, const char* host, int port, const uint8_t* buf,
                     uint64_t len) {
  return static_cast<Transport*>(h)->SendToAddr(host, port, buf, size_t(len));
}

int64_t gx_recv(void* h, uint8_t** out, double timeout_s) {
  return static_cast<Transport*>(h)->Recv(out, timeout_s);
}

void gx_free(uint8_t* buf) { ::free(buf); }

uint64_t gx_send_bytes(void* h) {
  return static_cast<Transport*>(h)->send_bytes();
}

uint64_t gx_recv_bytes(void* h) {
  return static_cast<Transport*>(h)->recv_bytes();
}

void gx_stop(void* h) { static_cast<Transport*>(h)->Stop(); }

void gx_destroy(void* h) { delete static_cast<Transport*>(h); }

}  // extern "C"
