// TCPStore — native rendezvous key-value store of the PyTorch port, a copy
// of paddle_tpu/native/tcp_store.cc.
//
// Reference parity: paddle/fluid/distributed/store/tcp_store.cc (+ store.h,
// tcp_utils.cc) — the socket KV store rank 0 hosts for bootstrap. Here it
// backs paddle_tpu_torch.distributed.TCPStore: the control-plane store of
// the launcher's rendezvous, rpc and the parameter server.
//
// Design: single acceptor thread + one thread per connection; an in-memory
// map<string, vector<uint8>> guarded by a mutex + condition_variable so GET
// can block until a key appears (the reference's Wait semantics). Wire
// protocol (little-endian), the reference package's, so clients and
// servers of both packages interoperate:
//   request : u8 op | u32 klen | key bytes | u32 vlen | value bytes
//   response: i64 status/arith | u32 vlen | value bytes
//   ops: 0 SET, 1 GET(blocking, vlen=timeout_ms), 2 ADD(i64 delta in value),
//        3 CHECK (returns 1 if key exists), 4 DELETE.
//
// Exposed as a flat C ABI for ctypes; built with g++ by
// paddle_tpu_torch/kernels/build.py (build_host) at first use.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Store {
  std::map<std::string, std::vector<uint8_t>> data;
  std::mutex mu;
  std::condition_variable cv;
};

struct Server {
  int listen_fd = -1;
  std::atomic<bool> stop{false};
  std::thread acceptor;
  std::mutex conn_mu;                 // guards workers + client_fds
  std::vector<std::thread> workers;   // mutated by acceptor, joined once
  std::vector<int> client_fds;
  Store store;
  ~Server() { shutdown(); }

  void shutdown() {
    bool expected = false;
    if (!stop.compare_exchange_strong(expected, true)) return;
    if (listen_fd >= 0) {
      ::shutdown(listen_fd, SHUT_RDWR);
      ::close(listen_fd);
    }
    if (acceptor.joinable()) acceptor.join();  // no more workers spawn now
    {
      // wake blocked GET waiters and unblock recv()s
      std::lock_guard<std::mutex> lk(store.mu);
      store.cv.notify_all();
    }
    std::vector<std::thread> ws;
    {
      std::lock_guard<std::mutex> lk(conn_mu);
      for (int fd : client_fds) ::shutdown(fd, SHUT_RDWR);
      ws.swap(workers);
    }
    for (auto& w : ws)
      if (w.joinable()) w.join();
  }
};

bool read_n(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_n(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void serve_conn(Server* srv, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  for (;;) {
    uint8_t op;
    uint32_t klen, vlen;
    if (!read_n(fd, &op, 1) || !read_n(fd, &klen, 4)) break;
    if (klen > (1u << 20)) break;
    std::string key(klen, '\0');
    if (!read_n(fd, key.data(), klen) || !read_n(fd, &vlen, 4)) break;
    if (vlen > (1u << 30)) break;
    std::vector<uint8_t> val(vlen);
    if (vlen && !read_n(fd, val.data(), vlen)) break;

    int64_t status = 0;
    std::vector<uint8_t> out;
    Store& st = srv->store;
    switch (op) {
      case 0: {  // SET
        std::lock_guard<std::mutex> lk(st.mu);
        st.data[key] = std::move(val);
        st.cv.notify_all();
        break;
      }
      case 1: {  // GET with timeout_ms encoded as the value payload (i64)
        int64_t timeout_ms = -1;
        if (val.size() == 8) std::memcpy(&timeout_ms, val.data(), 8);
        std::unique_lock<std::mutex> lk(st.mu);
        auto ready = [&] { return st.data.count(key) || srv->stop.load(); };
        if (timeout_ms < 0) {
          st.cv.wait(lk, ready);
        } else if (!st.cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   ready)) {
          status = -2;  // timeout
        }
        if (status == 0 && st.data.count(key)) {
          out = st.data[key];
        } else if (status == 0) {
          status = -1;  // server stopping
        }
        break;
      }
      case 2: {  // ADD (i64 delta) -> new value, stored as decimal string
        int64_t delta = 0;
        if (val.size() == 8) std::memcpy(&delta, val.data(), 8);
        std::lock_guard<std::mutex> lk(st.mu);
        int64_t cur = 0;
        auto it = st.data.find(key);
        if (it != st.data.end())
          cur = std::strtoll(
              std::string(it->second.begin(), it->second.end()).c_str(),
              nullptr, 10);
        cur += delta;
        std::string s = std::to_string(cur);
        st.data[key].assign(s.begin(), s.end());
        status = cur;
        st.cv.notify_all();
        break;
      }
      case 3: {  // CHECK
        std::lock_guard<std::mutex> lk(st.mu);
        status = st.data.count(key) ? 1 : 0;
        break;
      }
      case 4: {  // DELETE
        std::lock_guard<std::mutex> lk(st.mu);
        status = st.data.erase(key) ? 1 : 0;
        break;
      }
      default:
        status = -100;
    }
    uint32_t olen = static_cast<uint32_t>(out.size());
    if (!write_n(fd, &status, 8) || !write_n(fd, &olen, 4)) break;
    if (olen && !write_n(fd, out.data(), olen)) break;
  }
  {
    // Deregister before close: shutdown() replays ::shutdown over
    // client_fds, and a stale entry could hit an unrelated descriptor the
    // process has since reused under the same number.
    std::lock_guard<std::mutex> lk(srv->conn_mu);
    auto& v = srv->client_fds;
    v.erase(std::remove(v.begin(), v.end(), fd), v.end());
  }
  ::close(fd);
}

}  // namespace

extern "C" {

// ---- server ----
void* ts_server_start(int port) {
  auto* srv = new Server();
  srv->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (srv->listen_fd < 0) {
    delete srv;
    return nullptr;
  }
  int one = 1;
  setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(srv->listen_fd, 128) != 0) {
    ::close(srv->listen_fd);
    delete srv;
    return nullptr;
  }
  srv->acceptor = std::thread([srv] {
    while (!srv->stop.load()) {
      int fd = ::accept(srv->listen_fd, nullptr, nullptr);
      if (fd < 0) break;
      std::lock_guard<std::mutex> lk(srv->conn_mu);
      if (srv->stop.load()) {
        ::close(fd);
        break;
      }
      srv->client_fds.push_back(fd);
      srv->workers.emplace_back(serve_conn, srv, fd);
    }
  });
  return srv;
}

void ts_server_stop(void* h) {
  auto* srv = static_cast<Server*>(h);
  if (srv) {
    srv->shutdown();
    delete srv;
  }
}

// ---- client ----
void* ts_client_connect(const char* host, int port, int timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  // bounded connect retries (the server may come up a moment later — the
  // reference retries for ~15 min; callers pass their own budget)
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms : 1);
  while (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
         0) {
    if (std::chrono::steady_clock::now() >= deadline) {
      ::close(fd);
      return nullptr;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    ::close(fd);
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return reinterpret_cast<void*>(static_cast<intptr_t>(fd) + 1);
}

void ts_client_close(void* h) {
  if (h) ::close(static_cast<int>(reinterpret_cast<intptr_t>(h) - 1));
}

static int64_t roundtrip(void* h, uint8_t op, const char* key,
                         const uint8_t* val, uint32_t vlen, uint8_t* out,
                         uint32_t out_cap, uint32_t* out_len) {
  int fd = static_cast<int>(reinterpret_cast<intptr_t>(h) - 1);
  uint32_t klen = static_cast<uint32_t>(std::strlen(key));
  if (!write_n(fd, &op, 1) || !write_n(fd, &klen, 4) ||
      !write_n(fd, key, klen) || !write_n(fd, &vlen, 4) ||
      (vlen && !write_n(fd, val, vlen)))
    return -200;
  int64_t status;
  uint32_t olen;
  if (!read_n(fd, &status, 8) || !read_n(fd, &olen, 4)) return -201;
  if (out_len) *out_len = olen;
  if (olen) {
    std::vector<uint8_t> tmp(olen);
    if (!read_n(fd, tmp.data(), olen)) return -202;
    if (out && out_cap >= olen) std::memcpy(out, tmp.data(), olen);
    else if (out) return -203;  // caller buffer too small
  }
  return status;
}

int64_t ts_set(void* h, const char* key, const uint8_t* val, uint32_t vlen) {
  return roundtrip(h, 0, key, val, vlen, nullptr, 0, nullptr);
}

int64_t ts_get(void* h, const char* key, int64_t timeout_ms, uint8_t* out,
               uint32_t out_cap, uint32_t* out_len) {
  return roundtrip(h, 1, key, reinterpret_cast<uint8_t*>(&timeout_ms), 8, out,
                   out_cap, out_len);
}

int64_t ts_add(void* h, const char* key, int64_t delta) {
  return roundtrip(h, 2, key, reinterpret_cast<uint8_t*>(&delta), 8, nullptr,
                   0, nullptr);
}

int64_t ts_check(void* h, const char* key) {
  return roundtrip(h, 3, key, nullptr, 0, nullptr, 0, nullptr);
}

int64_t ts_delete(void* h, const char* key) {
  return roundtrip(h, 4, key, nullptr, 0, nullptr, 0, nullptr);
}

}  // extern "C"
